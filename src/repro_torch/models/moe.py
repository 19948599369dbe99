"""Mixture-of-Experts layer of the port: top-k routing with capacity and
sort-based dispatch.

PyTorch counterpart of ``repro.models.moe`` on one device, with the
reference's arithmetic: the router's logits in float32 from the working-
dtype router, softmax, top-k renormalized by ``max(Σ, 1e-9)``, the
Switch load-balancing loss ``E · Σ_e f_e · P_e``, the capacity
``int(max(1, cf · N · k / E))`` (tokens past it are dropped, at decode
too), a stable sort of the (token, choice) stream by expert with the
sentinel slot ``E · cap`` for dropped entries, every expert's swiglu FFN
batched over the experts, and the shared expert added last.

Under tensor parallelism (``ctx`` active, the reference's dist branch)
the layer is expert-parallel: the router is column-parallel and its
logits are gathered over the experts when it is split (routing and the
aux loss need every expert), each rank dispatches only to its contiguous
expert block ``[e0, e0 + E_local)``, the shared expert is column/row-
parallel, and the partial terms are finished by one ``psum_scatter``
(the replicated ones by ``scatter_seq``).  When ``n_experts`` does not
divide tp the experts are replicated and only the shared expert is
split.  Under sequence parallelism the layer gathers the sequence once
before routing (the capacity and the aux statistics count every token)
and the combine reduce-scatters back to the local block.

The token permutation into and out of the slots (dispatch, combine and
their backward passes) runs through ``kernels.ops``: on the card four
hand-written gathers over :func:`shuffle_plan` (``csrc/moe_shuffle.cu``),
on the CPU their plain version (``kernels.ref``: PyTorch's index ops).

Repeatability: no accumulation here depends on the order threads run
in.  A token's k copies are summed over k in order (the reference
scatter-adds them), and each pass of the kernels writes every output
row once, from one group of threads; in the plain version every gather
is a permutation or writes each real row once, so its backward adds one
value into each row, and the only row that gathers many (the sentinel)
is discarded.  Ties in the top-k resolve to the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does
not promise an order).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.dist.sharding import NULL_CTX
from repro_torch.kernels import ops


def init_moe(d: int, ff: int, E: int, n_shared: int,
             generator: Optional[torch.Generator], device="cpu",
             dtype=torch.float32, lead: Tuple[int, ...] = (),
             keep=None) -> Dict:
    """N(0, 0.02²) weights keyed like the reference's ``init_moe``:
    ``router`` (d, E), ``we_g``/``we_u`` (E, d, ff), ``we_d`` (E, ff, d)
    and, with ``n_shared``, ``ws_g``/``ws_u`` (d, ff·n_shared) and
    ``ws_d`` (ff·n_shared, d); ``lead`` prepends the stacked layer axis.
    ``keep(name, full)`` → the part of each leaf to keep, as it is drawn
    (a rank's slice under TP: the peak is one full leaf); None keeps all."""
    def normal(name, *shape):
        t = torch.randn(lead + shape, generator=generator, dtype=dtype,
                        device=device)
        return (t if keep is None else keep(name, t)).mul_(0.02)

    p = {"router": normal("router", d, E), "we_g": normal("we_g", E, d, ff),
         "we_u": normal("we_u", E, d, ff), "we_d": normal("we_d", E, ff, d)}
    if n_shared:
        p["ws_g"] = normal("ws_g", d, ff * n_shared)
        p["ws_u"] = normal("ws_u", d, ff * n_shared)
        p["ws_d"] = normal("ws_d", ff * n_shared, d)
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert, in Python float arithmetic as the reference."""
    return int(max(1, capacity_factor * n_tokens * top_k / n_experts))


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int,
          ctx=NULL_CTX, n_experts: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs (N, E), top_p (N, k) renormalized, top_e (N, k))`` of the
    tokens ``xf`` (N, d); logits and probabilities in float32.  Under TP
    a column-parallel router's logits (``n_experts`` wider than its
    columns) are gathered over the experts; a replicated router's are
    already whole, and gathering them again would duplicate experts."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    if ctx.active and n_experts is not None \
            and logits.shape[-1] != n_experts:
        logits = ctx.all_gather(logits, axis=-1)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def dispatch_slots(top_e: torch.Tensor, n_experts: int, cap: int,
                   e0: int = 0, n_local: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort-based dispatch plan of the (token, choice) stream:
    ``(order, slot, counts)`` — the stable sort by expert, each sorted
    entry's buffer slot ``(e − e0) · cap + rank`` (``n_local · cap``, the
    sentinel, where its rank within its expert reaches ``cap`` or its
    expert lies outside this rank's block ``[e0, e0 + n_local)``; the
    whole range by default), and the entries routed to each expert."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(n_experts, device=flat_e.device,
                           dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - seg_start[sorted_e]
    n_local = n_experts if n_local is None else n_local
    keep = rank < cap
    if n_local != n_experts:
        keep = keep & (sorted_e >= e0) & (sorted_e < e0 + n_local)
    slot = torch.where(keep, (sorted_e - e0) * cap + rank,
                       torch.full_like(rank, n_local * cap))
    return order, slot, counts


class ShufflePlan(NamedTuple):
    """Where each (token, choice) entry ``e = t·k + j`` goes."""
    order: torch.Tensor    # (N·k,) the stable sort by expert
    slot: torch.Tensor     # (N·k,) each sorted entry's slot, or the sentinel
    slot_tk: torch.Tensor  # (N, k) int32: entry e's slot, or −1 (dropped)
    src: torch.Tensor      # (n_slots,) int32: the entry in slot s, or −1
    top_k: int


def shuffle_plan(order: torch.Tensor, slot: torch.Tensor, top_k: int,
                 n_slots: int) -> ShufflePlan:
    """:func:`dispatch_slots`' plan seen from both sides, in a few integer
    ops over the entries: ``slot_tk``, each entry's slot (−1 where it
    passed its expert's capacity or its expert lies on another rank),
    and ``src``, the entry that fills each of the ``n_slots`` slots (−1
    where empty).  Both are scatters by a permutation; the dropped
    entries all land on the sentinel ``src[n_slots]``, which is cut off."""
    slot32 = slot.to(torch.int32)
    slot_tk = torch.empty_like(slot32)
    slot_tk[order] = torch.where(slot32 < n_slots, slot32, -1)
    src = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                     device=order.device)
    src[slot] = order.to(torch.int32)
    return ShufflePlan(order, slot, slot_tk.reshape(-1, top_k),
                       src[:n_slots], top_k)


def _shared(params: Dict, xf: torch.Tensor) -> torch.Tensor:
    return (F.silu(xf @ params["ws_g"]) * (xf @ params["ws_u"])) \
        @ params["ws_d"]


def moe_ffn(params: Dict, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, ctx=NULL_CTX,
            shared_width: Optional[int] = None,
            n_experts: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, d) → (output (B, S, d), load-balancing aux loss, a
    float32 scalar).  ``shared_width`` (the global ``n_shared · ff``) and
    ``n_experts`` (the global E) tell the TP branches a rank's split
    leaves from whole ones; under SP ``x`` is the local sequence block
    and so is the output."""
    x = ctx.gather_seq(x)
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    E_local = params["we_g"].shape[-3]
    with obs.span("moe.route", grad=True) as (enter, exit):
        probs, top_p, top_e = route(params["router"], enter(xf), top_k, ctx,
                                    n_experts)
        E = probs.shape[-1]

        # aux load-balancing loss (Switch): E · Σ_e f_e · P_e
        cap = capacity(N, top_k, E, capacity_factor)
        # TP: this rank's contiguous expert block [e0, e0 + E_local);
        # routing stays global, the dispatch keeps only local experts
        experts_sharded = ctx.active and E_local != E
        e0 = ctx.axis_index() * E_local if experts_sharded else 0
        order, slot, counts = dispatch_slots(top_e, E, cap, e0, E_local)
        fe = counts.to(torch.float32) / (N * top_k)
        aux = E * torch.sum(fe * probs.mean(dim=0))
        top_p, aux = exit(top_p, aux)
    # entries past their local expert's capacity
    obs.count("moe.routed", N * top_k)
    obs.count("moe.dropped",
              lambda: (counts[e0:e0 + E_local] - cap).clamp_(min=0).sum())

    # dispatch: the sorted stream into the E_local·cap slots
    with obs.span("moe.dispatch", grad=True) as (enter, exit):
        plan = shuffle_plan(order, slot, top_k, E_local * cap)
        buf = exit(ops.moe_dispatch(enter(xf), plan).reshape(E_local, cap,
                                                             d))

    # every expert's swiglu FFN, batched over the experts
    with obs.span("moe.experts", grad=True) as (enter, exit):
        buf = enter(buf)
        h = F.silu(torch.bmm(buf, params["we_g"])) * torch.bmm(
            buf, params["we_u"])
        out_buf = exit(torch.bmm(h, params["we_d"]).reshape(E_local * cap,
                                                            d))

    # combine: gather back, weight and sum each token's k copies in order
    with obs.span("moe.combine", grad=True) as (enter, exit):
        out_buf, top_p = enter(out_buf, top_p)
        y = exit(ops.moe_combine(out_buf, top_p, plan))

    sh, sh_sharded = None, False
    if "ws_g" in params:  # shared expert (llama4)
        sh = _shared(params, xf)
        sh_sharded = (ctx.active and shared_width is not None
                      and params["ws_g"].shape[-1] != shared_width)
    if not ctx.active:
        out = y if sh is None else y + sh
        return out.reshape(B, S, d).to(x.dtype), aux
    # one collective over "model": the partial terms (this rank's experts,
    # the column/row-parallel shared expert) summed inside it, a
    # replicated term sliced to the local sequence block and added after
    y = y.reshape(B, S, d)
    sh = None if sh is None else sh.reshape(B, S, d)
    partial = y if experts_sharded else None
    if sh is not None and sh_sharded:
        partial = sh if partial is None else partial + sh
    out = None if partial is None else ctx.psum_scatter(partial)
    for t, split in ((y, experts_sharded), (sh, sh_sharded)):
        if t is not None and not split:
            t = ctx.scatter_seq(t)
            out = t if out is None else out + t
    return out.to(x.dtype), aux


def moe_ffn_reference(params: Dict, x: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Dense oracle: every expert on every token, masked by the routing;
    no capacity drops.  O(N·E) work — tests only."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs, top_p, top_e = route(params["router"], xf, top_k)
    gate = torch.zeros_like(probs).scatter(1, top_e, top_p)
    h = F.silu(torch.einsum("nd,edf->enf", xf, params["we_g"])) \
        * torch.einsum("nd,edf->enf", xf, params["we_u"])
    per_e = torch.einsum("enf,efd->end", h, params["we_d"])
    y = torch.einsum("end,ne->nd", per_e, gate.to(per_e.dtype))
    if "ws_g" in params:
        y = y + _shared(params, xf)
    return y.reshape(B, S, d).to(x.dtype)
