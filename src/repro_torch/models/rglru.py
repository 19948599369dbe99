"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427).

PyTorch counterpart of ``repro.models.rglru``.  Gated linear recurrence:

    r_t = σ(y_t W_a + b_a)              (recurrence gate)
    i_t = σ(y_t W_x + b_x)              (input gate)
    a_t = a^{c·r_t},  a = σ(Λ)          (per-channel learned decay, c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ y_t)

The full-sequence form solves the first-order recurrence with a
log-depth doubling scan (:func:`_linear_scan`: ⌈log2 S⌉ elementwise
passes of length S), where the reference runs ``lax.associative_scan``;
a Python loop over S would launch S × layers times a training step.
Decode is the O(1) update on a float32 state.

The block (as in Griffin): two width-``r`` branches, a GeLU gate and a
conv1d(4) → RG-LRU branch, merged multiplicatively and projected back to
d_model.

Tensor parallelism (``ctx`` active, the reference's dist branch): the
gate and lin branches are column-parallel over the recurrence width (the
conv follows its channels), ``w_a``/``w_x`` are row-parallel with one
psum of the stacked pre-activations (re-sliced to the local block, so
the recurrence stays rank-local), ``b_a``, ``b_x``, ``lam`` and
``conv_b`` are sliced by ``local_block``, and ``w_out`` is row-parallel.
Under sequence parallelism the block gathers the sequence before the
scan and ``w_out``'s reduce-scatter returns the local block.  The decode
step's TP form keeps a rank's channels in its states and psums
``w_out``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import NULL_CTX
from repro_torch.models.ssm import _mm

_C = 8.0


def init_rglru_block(d: int, r: int, d_conv: int,
                     generator: Optional[torch.Generator], device="cpu",
                     dtype=torch.float32, lead: Tuple[int, ...] = (),
                     keep=None) -> Dict:
    """The reference's leaves: six N(0, 0.02²) matrices from the
    generator, zero biases, and the deterministic ``lam = logit(linspace
    (0.9, 0.999, r))`` (so that a = σ(Λ) spans [0.9, 0.999]).  ``lead``
    prepends the stacked layer axis; vectors of a stacked layer are in
    ``dtype``, an unstacked layer's stay float32 (``ssm.init_ssm``).
    ``keep(name, full)`` → the part of each matrix to keep, as it is
    drawn (a rank's slice under TP; None keeps all)."""
    vdt = dtype if lead else torch.float32

    def normal(name, *shape):
        t = torch.randn(lead + shape, generator=generator, dtype=dtype,
                        device=device)
        return (t if keep is None else keep(name, t)).mul_(0.02)

    def vec(values):
        return values.to(device=device, dtype=vdt).expand(
            lead + values.shape).clone()

    a = torch.linspace(0.9, 0.999, r)
    return {
        "w_gate": normal("w_gate", d, r),
        "w_lin": normal("w_lin", d, r),
        "conv_w": normal("conv_w", d_conv, r),
        "conv_b": vec(torch.zeros(r)),
        "w_a": normal("w_a", r, r),
        "b_a": vec(torch.zeros(r)),
        "w_x": normal("w_x", r, r),
        "b_x": vec(torch.zeros(r)),
        "lam": vec(torch.log(a / (1 - a))),
        "w_out": normal("w_out", r, d),
    }


def _gates(params: Dict, y: torch.Tensor, ctx=NULL_CTX
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's (a_t, b_t) of ``y`` (B, S, r), float32; the
    gates' matrices upcast to float32 as the reference does.  Under TP
    ``y`` holds this rank's block of the width and ``w_a``/``w_x`` are
    row-parallel: one psum restores both full pre-activations, which are
    re-sliced to the local block."""
    yf = y.to(torch.float32)
    r_local = y.shape[-1]
    pre_a = yf @ params["w_a"].to(torch.float32)
    pre_x = yf @ params["w_x"].to(torch.float32)
    if ctx.active and params["w_a"].shape[-2] != params["w_a"].shape[-1]:
        pre_a, pre_x = ctx.psum(torch.stack([pre_a, pre_x])).unbind(0)
    rgate = torch.sigmoid(ctx.local_block(pre_a + params["b_a"], r_local))
    igate = torch.sigmoid(ctx.local_block(pre_x + params["b_x"], r_local))
    lam = ctx.local_block(params["lam"], r_local)
    log_a = -_C * rgate * F.softplus(lam)  # log a_t <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a), min=1e-12))
    return a, mult * igate * yf


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t from h_{−1} = 0 along dim 1, by doubling:
    after the pass of offset d, (a_t, b_t) compose the steps t−2d+1..t,
    so ⌈log2 S⌉ passes leave b_t = h_t.  Out of place (autograd)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < S:  # the last pass needs no composed a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(params: Dict, y: torch.Tensor,
               h0: Optional[torch.Tensor] = None, ctx=NULL_CTX
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU; y (B, S, r) → (h in y's dtype, the last
    state in float32)."""
    a, b = _gates(params, y, ctx)
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(y.dtype), h[:, -1]


def rglru_step(params: Dict, y1: torch.Tensor, h: torch.Tensor,
               ctx=NULL_CTX) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; y1 (B, 1, r), h (B, r) float32."""
    a, b = _gates(params, y1, ctx)
    h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return h_new.to(y1.dtype)[:, None, :], h_new


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, without an activation (unlike
    ``ssm._causal_conv``): seq (B, S, C), w (K, C)."""
    K, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = torch.zeros_like(seq)
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[k]
    return out + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _out(params: Dict, h: torch.Tensor, cfg, ctx, finish) -> torch.Tensor:
    """``w_out``'s output, finished by ``finish`` when it is row-parallel
    (a rank's block of the width), else sliced to the local block."""
    out = _mm(h, params["w_out"])
    if ctx.active and params["w_out"].shape[-2] != (cfg.lru_width
                                                   or cfg.d_model):
        return finish(out)
    return ctx.scatter_seq(out)


def rglru_block_forward(params: Dict, x: torch.Tensor, cfg,
                        ctx=NULL_CTX) -> torch.Tensor:
    """Full recurrent block (training, full forward); x (B, S, d), under
    SP the local sequence block."""
    x = ctx.gather_seq(x)  # gather before the scan: it needs all of S
    gate = _gelu(_mm(x, params["w_gate"]))
    y = _mm(x, params["w_lin"])
    y = _causal_conv(y, params["conv_w"],
                     ctx.local_block(params["conv_b"], y.shape[-1]))
    h, _ = rglru_scan(params, y, ctx=ctx)
    return _out(params, gate * h, cfg, ctx, ctx.psum_scatter)


def rglru_init_cache(cfg, batch: int, lead: Tuple[int, ...] = (),
                     device="cpu", tp: int = 1) -> Dict:
    """Zero decode state, float32 whatever the model dtype (as the
    reference's); ``lead`` prepends the stacked layer axis.  Under TP
    (``tp``) a rank's block of the width."""
    r = (cfg.lru_width or cfg.d_model) // tp
    f32 = torch.float32
    return {
        "h": torch.zeros(lead + (batch, r), dtype=f32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, r), dtype=f32,
                            device=device),
    }


def rglru_block_step(params: Dict, x1: torch.Tensor, cache: Dict, cfg,
                     ctx=NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """One token: x1 (B, 1, d) → (out (B, 1, d), new cache); under TP a
    rank's block of the width, ``w_out`` psum'd."""
    gate = _gelu(_mm(x1, params["w_gate"]))
    y = _mm(x1, params["w_lin"])
    hist = torch.cat([cache["conv"], y.to(cache["conv"].dtype)], dim=1)
    w = params["conv_w"]
    win = hist[:, -w.shape[0]:]
    y = torch.einsum("bkc,kc->bc", win,
                     w.to(torch.promote_types(win.dtype, w.dtype)))
    y = (y + ctx.local_block(params["conv_b"], y.shape[-1]))[:, None, :]
    hs, h_new = rglru_step(params, y.to(x1.dtype), cache["h"], ctx)
    return (_out(params, gate * hs, cfg, ctx, ctx.psum),
            {"h": h_new, "conv": hist[:, 1:]})
