"""Port vs reference: the MoE layer (``models/moe.py``) on the same weights.

The reference's ``init_moe`` makes the weights and numpy makes the
input; both layers run in float32 on the CPU.  Tolerances: rtol 1e-4,
atol 1e-5 on the output, the aux loss and the gradients (the same
float32 arithmetic up to summation order: the port sums a token's k
copies over an axis where the reference scatter-adds them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from torch_reference import RecordingOptimizer as _Recording
from torch_reference import few_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
D, FF = 16, 8


def _setup(seed, E, n_shared, B=2, S=12):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, FF, E, n_shared,
                       jnp.float32)
    x = (np.random.default_rng(seed + 1).normal(size=(B, S, D)) * 0.5
         ).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp, x


CASES = [(E, k, cf, ns) for E in (4, 40) for k in (1, 2, 8) if k <= E
         for cf in (8.0, 1.25, 0.25) for ns in (0, 1)]


@pytest.mark.parametrize("E,top_k,cf,n_shared", CASES,
                         ids=[f"E{E}-k{k}-cf{cf}-sh{ns}"
                              for E, k, cf, ns in CASES])
def test_moe_ffn_matches_reference(E, top_k, cf, n_shared):
    jp, tp, x = _setup(E + top_k, E, n_shared)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=top_k,
                            capacity_factor=cf)
    y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), top_k, cf)
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


GRAD_CASES = [(4, 2, 8.0, 0), (4, 2, 0.25, 0), (40, 8, 1.25, 1),
              (40, 1, 0.25, 1)]


@pytest.mark.parametrize("E,top_k,cf,n_shared", GRAD_CASES,
                         ids=[f"E{E}-k{k}-cf{cf}-sh{ns}"
                              for E, k, cf, ns in GRAD_CASES])
def test_moe_gradients_match_reference(E, top_k, cf, n_shared):
    """∇ of Σy² + 0.01·aux with respect to every param and to x."""
    jp, tp, x = _setup(3 * E + top_k, E, n_shared)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, top_k=top_k, capacity_factor=cf)
        return jnp.sum(y ** 2) + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(leaves, xt, top_k, cf)
    grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux,
                                [*leaves.values(), xt])
    for (key, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)


@pytest.mark.parametrize("E,top_k,n_shared", [(4, 1, 0), (4, 2, 1),
                                              (40, 8, 0)])
def test_dense_oracle_matches_reference(E, top_k, n_shared):
    jp, tp, x = _setup(5 + E, E, n_shared)
    want = jmoe.moe_ffn_reference(jp, jnp.asarray(x), top_k)
    got = tmoe.moe_ffn_reference(tp, torch.from_numpy(x), top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with room for every token the dispatch equals the oracle
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), top_k, 8.0)
    np.testing.assert_allclose(y.numpy(), got.numpy(), **TOL)


def test_capacity_drops_at_decode():
    """granite-moe's decode step (N = B = 4 tokens, k 8 of 40 experts,
    cf 1.25) has one slot per expert, so tokens that share an expert are
    dropped — as in the reference's decode step."""
    assert tmoe.capacity(4, 8, 40, 1.25) == 1
    assert tmoe.capacity(4, 1, 128, 1.25) == 1
    assert tmoe.capacity(2048, 8, 40, 1.25) == 512
    jp, tp, x = _setup(11, 40, 0, B=4, S=1)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=8, capacity_factor=1.25)
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), 8, 1.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    dense = tmoe.moe_ffn_reference(tp, torch.from_numpy(x), 8)
    assert not torch.allclose(y, dense, rtol=1e-4, atol=1e-5)


def test_ties_route_to_the_lower_expert():
    """A zero router ties every expert: like ``jax.lax.top_k`` the port
    takes the lowest indices, so the aux loss is the reference's."""
    jp, tp, x = _setup(13, 8, 0)
    jp = dict(jp, router=jnp.zeros((D, 8)))
    tp = dict(tp, router=torch.zeros(D, 8))
    _, top_p, top_e = tmoe.route(tp["router"], torch.from_numpy(x[0]), 3)
    assert (top_e == torch.tensor([0, 1, 2])).all()
    _, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=3, capacity_factor=8.0)
    _, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), 3, 8.0)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_backward_repeats_bit_for_bit():
    """Two backward passes of one input give the same bits (no gradient
    accumulation here depends on the order threads run in)."""
    _, tp, x = _setup(17, 40, 1, B=4, S=16)

    def grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = tmoe.moe_ffn(leaves, xt, 8, 1.25)
        return torch.autograd.grad((y ** 2).sum() + 0.01 * aux,
                                   [*leaves.values(), xt])

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def test_coded_moe_step_decodes_lambda_data_and_uniform_aux():
    """The coded MoE step's decoded gradient is Σ λ_ij ∇L_ij + (0.01/n)
    Σ ∇aux_ij, computed here group by group (a straggler with λ = 0
    included: its aux term still counts); its metrics are Σ λ_ij L_ij
    and Σ aux_ij / n."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.mesh import OneCardMesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as ttf

    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              dtype="float32")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu", dtype=torch.float32)
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    mesh = OneCardMesh(2, 2)
    rng = np.random.default_rng(4)
    B, S = 8, 12
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "weights": torch.from_numpy(rng.random((B, S)).astype(
                 np.float32)),
             "denom": torch.tensor(float(B * S))}
    lam = np.array([[1.5, 0.0], [0.5, 2.0]], np.float32)
    opt = _Recording()
    tcfg = TrainConfig(optimizer="sgd", grad_clip=0.0, dist_mode="coded")
    step = steps._make_dist_train_step(cfg, tcfg, mesh, optimizer=opt)
    _, _, _, metrics = step(params, None, batch, lam, [], 0)

    n = mesh.pods * mesh.data
    want = None
    loss = aux = 0.0
    for i in range(mesh.pods):
        for j in range(mesh.data):
            rows = mesh.group_rows(i, j, B)
            local = {k: (v[rows] if v.ndim else v) for k, v in batch.items()}
            g_loss, m = steps._grads(params, cfg, local,
                                     objective=lambda m: m["loss"])
            g_aux, _ = steps._grads(params, cfg, local,
                                    objective=lambda m: (
                                        0.0 * m["loss"] + m["aux_loss"]))
            part = [lam[i, j] * a + (ttf.AUX_WEIGHT / n) * b
                    for a, b in zip(g_loss, g_aux)]
            want = part if want is None else [w + p for w, p in
                                              zip(want, part)]
            loss += float(lam[i, j]) * float(m["loss"])
            aux += float(m["aux_loss"]) / n
    for got, w in zip(opt.grads, want):
        scale = w.abs().max().item()
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * scale + 1e-9)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux_loss"]), aux, rtol=1e-6)
