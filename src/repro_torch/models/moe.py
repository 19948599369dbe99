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

The expert, tensor and sequence parallel branches of the reference (its
``ctx``) come with the dist regimes (ROADMAP.md); ``moe_ffn`` takes no
``ctx``.

Repeatability: no accumulation here depends on the order threads run
in.  The k copies of a token are unsorted back to ``(N, k, d)`` and
summed over k (the reference scatter-adds them); every gather is a
permutation or writes each real row once, so its backward adds one
value into each row; the only row that gathers many (the sentinel) is
discarded.  Ties in the top-k resolve to the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does
not promise an order).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def init_moe(d: int, ff: int, E: int, n_shared: int,
             generator: Optional[torch.Generator], device="cpu",
             dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Dict:
    """N(0, 0.02²) weights keyed like the reference's ``init_moe``:
    ``router`` (d, E), ``we_g``/``we_u`` (E, d, ff), ``we_d`` (E, ff, d)
    and, with ``n_shared``, ``ws_g``/``ws_u`` (d, ff·n_shared) and
    ``ws_d`` (ff·n_shared, d); ``lead`` prepends the stacked layer axis."""
    def normal(*shape):
        t = torch.randn(lead + shape, generator=generator, dtype=dtype,
                        device=device)
        return t.mul_(0.02)

    p = {"router": normal(d, E), "we_g": normal(E, d, ff),
         "we_u": normal(E, d, ff), "we_d": normal(E, ff, d)}
    if n_shared:
        p["ws_g"] = normal(d, ff * n_shared)
        p["ws_u"] = normal(d, ff * n_shared)
        p["ws_d"] = normal(ff * n_shared, d)
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert, in Python float arithmetic as the reference."""
    return int(max(1, capacity_factor * n_tokens * top_k / n_experts))


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs (N, E), top_p (N, k) renormalized, top_e (N, k))`` of the
    tokens ``xf`` (N, d); logits and probabilities in float32."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def dispatch_slots(top_e: torch.Tensor, n_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort-based dispatch plan of the (token, choice) stream:
    ``(order, slot, counts)`` — the stable sort by expert, each sorted
    entry's buffer slot ``e · cap + rank`` (``E · cap``, the sentinel,
    where its rank within its expert reaches ``cap``), and the entries
    routed to each expert."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(n_experts, device=flat_e.device,
                           dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - seg_start[sorted_e]
    slot = torch.where(rank < cap, sorted_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return order, slot, counts


def _shared(params: Dict, xf: torch.Tensor) -> torch.Tensor:
    return (F.silu(xf @ params["ws_g"]) * (xf @ params["ws_u"])) \
        @ params["ws_d"]


def moe_ffn(params: Dict, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, d) → (output (B, S, d), load-balancing aux loss, a
    float32 scalar).  One device; the dist regimes come later."""
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    E = params["router"].shape[-1]
    probs, top_p, top_e = route(params["router"], xf, top_k)

    # aux load-balancing loss (Switch): E · Σ_e f_e · P_e
    cap = capacity(N, top_k, E, capacity_factor)
    order, slot, counts = dispatch_slots(top_e, E, cap)
    fe = counts.to(torch.float32) / (N * top_k)
    aux = E * torch.sum(fe * probs.mean(dim=0))

    # dispatch: the sorted stream into (E·cap + 1) slots, the sentinel last
    x_sorted = xf[:, None, :].expand(N, top_k, d).reshape(N * top_k, d)
    x_sorted = x_sorted.index_select(0, order)
    buf = xf.new_zeros((E * cap + 1, d)).index_put((slot,), x_sorted)
    buf = buf[:E * cap].reshape(E, cap, d)

    # every expert's swiglu FFN, batched over the experts
    h = F.silu(torch.bmm(buf, params["we_g"])) * torch.bmm(buf,
                                                           params["we_u"])
    out_buf = torch.bmm(h, params["we_d"]).reshape(E * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])

    # combine: gather back, weight, unsort and sum the k copies in order
    w_sorted = top_p.reshape(-1).index_select(0, order)
    contrib = out_buf.index_select(0, slot) * w_sorted[:, None].to(
        out_buf.dtype)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    y = contrib.index_select(0, unsort).reshape(N, top_k, d).sum(dim=1)

    if "ws_g" in params:  # shared expert (llama4)
        y = y + _shared(params, xf)
    return y.reshape(B, S, d).to(x.dtype), aux


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
