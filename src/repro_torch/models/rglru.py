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
d_model.  The reference's tensor-parallel ``ShardCtx`` branches are not
ported (the dist regimes, ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import _mm

_C = 8.0


def init_rglru_block(d: int, r: int, d_conv: int,
                     generator: Optional[torch.Generator], device="cpu",
                     dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Dict:
    """The reference's leaves: six N(0, 0.02²) matrices from the
    generator, zero biases, and the deterministic ``lam = logit(linspace
    (0.9, 0.999, r))`` (so that a = σ(Λ) spans [0.9, 0.999]).  ``lead``
    prepends the stacked layer axis; vectors of a stacked layer are in
    ``dtype``, an unstacked layer's stay float32 (``ssm.init_ssm``)."""
    vdt = dtype if lead else torch.float32

    def normal(*shape):
        t = torch.randn(lead + shape, generator=generator, dtype=dtype,
                        device=device)
        return t.mul_(0.02)

    def vec(values):
        return values.to(device=device, dtype=vdt).expand(
            lead + values.shape).clone()

    a = torch.linspace(0.9, 0.999, r)
    return {
        "w_gate": normal(d, r),
        "w_lin": normal(d, r),
        "conv_w": normal(d_conv, r),
        "conv_b": vec(torch.zeros(r)),
        "w_a": normal(r, r),
        "b_a": vec(torch.zeros(r)),
        "w_x": normal(r, r),
        "b_x": vec(torch.zeros(r)),
        "lam": vec(torch.log(a / (1 - a))),
        "w_out": normal(r, d),
    }


def _gates(params: Dict, y: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's (a_t, b_t) of ``y`` (B, S, r), float32; the
    gates' matrices upcast to float32 as the reference does."""
    yf = y.to(torch.float32)
    pre_a = yf @ params["w_a"].to(torch.float32)
    pre_x = yf @ params["w_x"].to(torch.float32)
    rgate = torch.sigmoid(pre_a + params["b_a"])
    igate = torch.sigmoid(pre_x + params["b_x"])
    log_a = -_C * rgate * F.softplus(params["lam"])  # log a_t <= 0
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
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU; y (B, S, r) → (h in y's dtype, the last
    state in float32)."""
    a, b = _gates(params, y)
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(y.dtype), h[:, -1]


def rglru_step(params: Dict, y1: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; y1 (B, 1, r), h (B, r) float32."""
    a, b = _gates(params, y1)
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


def rglru_block_forward(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full recurrent block (training, full forward); x (B, S, d)."""
    gate = _gelu(_mm(x, params["w_gate"]))
    y = _mm(x, params["w_lin"])
    y = _causal_conv(y, params["conv_w"], params["conv_b"])
    h, _ = rglru_scan(params, y)
    return _mm(gate * h, params["w_out"])


def rglru_init_cache(cfg, batch: int, lead: Tuple[int, ...] = (),
                     device="cpu") -> Dict:
    """Zero decode state, float32 whatever the model dtype (as the
    reference's); ``lead`` prepends the stacked layer axis."""
    r = cfg.lru_width or cfg.d_model
    f32 = torch.float32
    return {
        "h": torch.zeros(lead + (batch, r), dtype=f32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, r), dtype=f32,
                            device=device),
    }


def rglru_block_step(params: Dict, x1: torch.Tensor, cache: Dict, cfg
                     ) -> Tuple[torch.Tensor, Dict]:
    """One token: x1 (B, 1, d) → (out (B, 1, d), new cache)."""
    gate = _gelu(_mm(x1, params["w_gate"]))
    y = _mm(x1, params["w_lin"])
    hist = torch.cat([cache["conv"], y.to(cache["conv"].dtype)], dim=1)
    w = params["conv_w"]
    win = hist[:, -w.shape[0]:]
    y = torch.einsum("bkc,kc->bc", win,
                     w.to(torch.promote_types(win.dtype, w.dtype)))
    y = (y + params["conv_b"])[:, None, :]
    hs, h_new = rglru_step(params, y.to(x1.dtype), cache["h"])
    return _mm(gate * hs, params["w_out"]), {"h": h_new, "conv": hist[:, 1:]}
