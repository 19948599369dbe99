"""The MoE layer's token permutation (``models/moe.py``): its plan, its
plain version and its route on the ``meta`` device, on the CPU.

  * :func:`~repro_torch.models.moe.shuffle_plan` (``slot_tk``, ``src``)
    against :func:`~repro_torch.models.moe.dispatch_slots` on random
    routings, with capacity drops and with a rank's expert block;
  * the CPU route (``kernels.ref``'s plain version) equals the layer as
    it was written before the kernels, bit for bit in float32: output,
    aux loss and every gradient;
  * the autograd Functions the card runs, with each kernel's gather
    written out here in PyTorch (the kernels themselves run only on the
    card: ``tests/test_torch_kernels_cuda.py``), against the plain
    version in float32; tolerance rtol 1e-5 and 1e-6 of the largest
    value: the two sum a token's k copies, and the weight's gradient
    over d, in other orders;
  * the ``meta`` route's shapes and its ``META_WORK``: the bytes each
    pass moves, counted as ``chip_smoke.py``'s bound counts them.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_shuffle, ops
from repro_torch.models import moe as tmoe
from torch_reference import few_threads  # noqa: F401 (autouse)


def _routing(seed, N, k, E):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(E, generator=g)[:k]
                        for _ in range(N)]).reshape(N, k)


# (N, k, E, capacity factor, TP ranks)
PLAN_CASES = [(37, 2, 4, 1.25, 1), (64, 8, 40, 1.25, 1), (64, 8, 40, 0.5, 1),
              (33, 1, 16, 2.0, 1), (4, 8, 40, 1.25, 1), (48, 4, 8, 1.0, 2),
              (40, 8, 40, 1.25, 4), (16, 1, 128, 1.25, 8)]


@pytest.mark.parametrize("N,k,E,cf,tp", PLAN_CASES,
                         ids=[f"N{N}-k{k}-E{E}-cf{cf}-tp{tp}"
                              for N, k, E, cf, tp in PLAN_CASES])
def test_plan_matches_dispatch_slots(N, k, E, cf, tp):
    top_e = _routing(N + k + E, N, k, E)
    cap = tmoe.capacity(N, k, E, cf)
    E_local = E // tp
    for rank in range(tp):
        e0 = rank * E_local
        order, slot, counts = tmoe.dispatch_slots(top_e, E, cap, e0,
                                                  E_local)
        plan = tmoe.shuffle_plan(order, slot, k, E_local * cap)
        n_slots = E_local * cap
        assert plan.slot_tk.shape == (N, k) and plan.src.shape == (n_slots,)
        assert plan.slot_tk.dtype == plan.src.dtype == torch.int32
        want_tk = torch.full((N * k,), -1, dtype=torch.int64)
        want_src = torch.full((n_slots,), -1, dtype=torch.int64)
        flat_e = top_e.reshape(-1)
        for p in range(N * k):
            e, s = int(order[p]), int(slot[p])
            local = e0 <= int(flat_e[e]) < e0 + E_local
            if s < n_slots:
                assert local
                want_tk[e] = s
                assert want_src[s] == -1  # a slot holds one entry
                want_src[s] = e
        assert torch.equal(plan.slot_tk.reshape(-1).long(), want_tk)
        assert torch.equal(plan.src.long(), want_src)
        # kept: within capacity and on this rank; each local expert's
        # first min(count, cap) entries of its run fill its first slots
        kept = int((want_tk >= 0).sum())
        assert kept == int(counts[e0:e0 + E_local].clamp(max=cap).sum())
        assert int((plan.src >= 0).sum()) == kept


# ----------------------------------------------------------------------
# the plain version is the layer as it was before the kernels
# ----------------------------------------------------------------------
def _moe_ffn_before(params, x, top_k, capacity_factor):
    """``models.moe.moe_ffn`` before the shuffle moved to ``kernels``
    (one device), kept here verbatim as the yardstick."""
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    E_local = params["we_g"].shape[-3]
    probs, top_p, top_e = tmoe.route(params["router"], xf, top_k)
    E = probs.shape[-1]
    cap = tmoe.capacity(N, top_k, E, capacity_factor)
    order, slot, counts = tmoe.dispatch_slots(top_e, E, cap, 0, E_local)
    fe = counts.to(torch.float32) / (N * top_k)
    aux = E * torch.sum(fe * probs.mean(dim=0))
    x_sorted = xf[:, None, :].expand(N, top_k, d).reshape(N * top_k, d)
    x_sorted = x_sorted.index_select(0, order)
    buf = xf.new_zeros((E_local * cap + 1, d)).index_put((slot,), x_sorted)
    buf = buf[:E_local * cap].reshape(E_local, cap, d)
    h = F.silu(torch.bmm(buf, params["we_g"])) * torch.bmm(
        buf, params["we_u"])
    out_buf = torch.bmm(h, params["we_d"]).reshape(E_local * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    w_sorted = top_p.reshape(-1).index_select(0, order)
    contrib = out_buf.index_select(0, slot) * w_sorted[:, None].to(
        out_buf.dtype)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    y = contrib.index_select(0, unsort).reshape(N, top_k, d).sum(dim=1)
    if "ws_g" in params:
        y = y + tmoe._shared(params, xf)
    return y.reshape(B, S, d).to(x.dtype), aux


def _params(seed, d, ff, E, n_shared, dtype=torch.float32):
    return tmoe.init_moe(d, ff, E, n_shared,
                         torch.Generator().manual_seed(seed), dtype=dtype)


def _x(seed, B, S, d, dtype=torch.float32):
    x = np.random.default_rng(seed).normal(size=(B, S, d)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _run(fn, params, x, top_k, cf):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xt = x.clone().requires_grad_(True)
    y, aux = fn(leaves, xt, top_k, cf)
    grads = torch.autograd.grad((y.float() ** 2).sum() + 0.01 * aux,
                                [*leaves.values(), xt])
    return y, aux, dict(zip([*leaves, "x"], grads))


# (E, k, capacity factor, shared experts)
PLAIN_CASES = [(4, 2, 8.0, 0), (8, 2, 0.5, 0), (40, 8, 1.25, 0),
               (40, 8, 0.25, 1), (16, 1, 1.25, 1)]


@pytest.mark.parametrize("E,k,cf,n_shared", PLAIN_CASES,
                         ids=[f"E{E}-k{k}-cf{cf}-sh{ns}"
                              for E, k, cf, ns in PLAIN_CASES])
def test_plain_version_equals_the_layer_before_the_kernels(E, k, cf,
                                                           n_shared):
    params, x = _params(E + k, 24, 16, E, n_shared), _x(E, 2, 20, 24)
    y0, a0, g0 = _run(_moe_ffn_before, params, x, k, cf)
    y1, a1, g1 = _run(tmoe.moe_ffn, params, x, k, cf)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


# ----------------------------------------------------------------------
# the autograd Functions, with each kernel's gather written out
# ----------------------------------------------------------------------
def _gather_sum(rows, slot_tk, w):
    """Σ_j (w[t, j] or 1) · rows[slot_tk[t, j]] over the kept j, in order,
    float32, rounded once."""
    N, k = slot_tk.shape
    acc = torch.zeros((N, rows.shape[-1]), dtype=torch.float32)
    for j in range(k):
        s = slot_tk[:, j].long()
        term = rows[s.clamp(min=0)].float()
        if w is not None:
            term = w[:, j, None] * term
        acc = acc + torch.where(s[:, None] >= 0, term, 0.0)
    return acc.to(rows.dtype)


def _combine_bwd(dy, out, w, slot_tk, src):
    k = slot_tk.shape[1]
    e = src.long()
    live = e >= 0
    g = dy[(e.clamp(min=0) // k)].float()
    we = w.reshape(-1)[e.clamp(min=0)]
    dout = torch.where(live[:, None], we[:, None] * g, 0.0).to(out.dtype)
    dw = torch.zeros(w.numel(), dtype=torch.float32)
    dw[e[live]] = (g * out.float()).sum(-1)[live]
    return dout, dw.reshape(w.shape)


@pytest.fixture
def gathers(monkeypatch):
    """The kernels' wrappers replaced by their gathers in PyTorch, and the
    layer's device route sent through the autograd Functions."""
    def dispatch(x, slot_tk, src):
        return torch.where(src[:, None] >= 0,
                           x[src.long().clamp(min=0) // slot_tk.shape[1]],
                           0.0).to(x.dtype)

    monkeypatch.setattr(moe_shuffle, "moe_dispatch", dispatch)
    monkeypatch.setattr(moe_shuffle, "moe_combine",
                        lambda out, w, slot_tk: _gather_sum(out, slot_tk, w))
    monkeypatch.setattr(moe_shuffle, "moe_dispatch_bwd",
                        lambda dbuf, slot_tk: _gather_sum(dbuf, slot_tk,
                                                          None))
    monkeypatch.setattr(moe_shuffle, "moe_combine_bwd", _combine_bwd)
    monkeypatch.setattr(ops, "_route", lambda t: t.device.type
                        if t.device.type == "meta" else "card")


@pytest.mark.parametrize("E,k,cf,n_shared", PLAIN_CASES,
                         ids=[f"E{E}-k{k}-cf{cf}-sh{ns}"
                              for E, k, cf, ns in PLAIN_CASES])
def test_functions_match_the_plain_version(gathers, E, k, cf, n_shared):
    params, x = _params(3 * E + k, 24, 16, E, n_shared), _x(E + 1, 2, 20, 24)
    y1, a1, g1 = _run(tmoe.moe_ffn, params, x, k, cf)
    y0, a0, g0 = _run(_moe_ffn_before, params, x, k, cf)
    assert torch.equal(a0, a1)
    for name, (got, want) in {"y": (y1, y0), **{
            n: (g1[n], g0[n]) for n in g0}}.items():
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * scale + 1e-12, msg=name)


def test_functions_drop_what_the_plan_drops(gathers):
    """At capacity 0.25 most entries are dropped: their weights' and the
    empty slots' gradients are zero, and a token with every entry dropped
    gets nothing from the experts."""
    N, k, E, d = 32, 4, 8, 16
    top_e = _routing(5, N, k, E)
    cap = tmoe.capacity(N, k, E, 0.25)
    order, slot, _ = tmoe.dispatch_slots(top_e, E, cap)
    plan = tmoe.shuffle_plan(order, slot, k, E * cap)
    x = _x(6, 1, N, d)[0].requires_grad_(True)
    w = torch.rand(N, k, generator=torch.Generator().manual_seed(7)
                   ).requires_grad_(True)
    buf = ops.moe_dispatch(x, plan)
    out = (buf * 2.0).detach().requires_grad_(True)
    y = ops.moe_combine(out, w, plan)
    dy = torch.ones_like(y)
    dout, dw = torch.autograd.grad(y, [out, w], dy)
    dropped = plan.slot_tk < 0
    assert dropped.any() and (dw[dropped] == 0).all()
    assert (dout[plan.src < 0] == 0).all() and (buf[plan.src < 0] == 0).all()
    none_kept = dropped.all(-1)
    assert (y[none_kept] == 0).all()
    (dx,) = torch.autograd.grad(buf, x, torch.ones_like(buf))
    n_kept = (~dropped).sum(-1, keepdim=True).float()
    assert torch.equal(dx, n_kept.expand_as(dx))


# ----------------------------------------------------------------------
# the meta route: shapes and the kernels' bytes
# ----------------------------------------------------------------------
def test_meta_route_shapes_and_work():
    """granite-moe's training shape (N 16,384, k 8, E 40, cap 4,096, d
    1,536, bf16) on ``meta``, forward and backward: each pass once, with
    the bytes of every slot the entries could fill (131,072 of 163,840:
    no routing is known there) and nothing launched."""
    N, k, E, d, cap = 16384, 8, 40, 1536, 4096
    n_slots = E * cap
    meta = dict(device="meta")
    top_e = torch.empty((N, k), dtype=torch.int64, **meta)
    order, slot, _ = tmoe.dispatch_slots(top_e, E, cap)
    plan = tmoe.shuffle_plan(order, slot, k, E * cap)
    assert plan.slot_tk.shape == (N, k) and plan.src.shape == (n_slots,)
    before = ops.launch_counts()
    ops.reset_meta_work()
    x = torch.empty((N, d), dtype=torch.bfloat16, **meta,
                    requires_grad=True)
    w = torch.empty((N, k), dtype=torch.float32, **meta, requires_grad=True)
    buf = ops.moe_dispatch(x, plan)
    y = ops.moe_combine(buf * 1.0, w, plan)
    assert buf.shape == (n_slots, d) and buf.dtype == torch.bfloat16
    assert y.shape == (N, d) and y.dtype == torch.bfloat16
    dx, dw = torch.autograd.grad(y, [x, w], torch.empty_like(y))
    assert dx.shape == (N, d) and dw.shape == (N, k)
    assert dw.dtype == torch.float32
    filled = N * k
    rows, toks, kept = n_slots * d * 2, N * d * 2, filled * d * 2
    want = {
        "moe_dispatch": (toks + 4 * N * k + 4 * n_slots + rows, 0),
        "moe_combine": (kept + 8 * N * k + toks, 2 * filled * d),
        "moe_dispatch_bwd": (kept + 4 * N * k + toks, filled * d),
        "moe_combine_bwd": (toks + kept + 4 * n_slots + 12 * N * k + rows,
                            3 * filled * d),
    }
    assert {n: (w["calls"], w["bytes"], w["flops"])
            for n, w in ops.META_WORK.items()} == {
        n: (1, b, f) for n, (b, f) in want.items()}
    # the issue's arithmetic: 503 MB of slots, ~50 MB of tokens
    assert want["moe_dispatch"][0] == pytest.approx(554.8e6, rel=1e-4)
    assert ops.launch_counts() == before
