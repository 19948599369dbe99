"""Mamba-2 (SSD, state-space duality) block of the port, chunked form.

PyTorch counterpart of ``repro.models.ssm`` (arXiv:2405.21060, minimal
form): per-head scalar decay ``dA_t = exp(dt_t · A)``, inputs
discretized as ``x̄_t = dt_t · x_t``, state ``H_t = dA_t·H_{t−1} + x̄_t ⊗
B_t``, output ``y_t = C_t · H_t + D · x_t``.

The full-sequence form (training, full forward) splits the sequence
into chunks of Q tokens: inside a chunk the dual, attention-like
product ``((C Bᵀ) ⊙ L) x̄``; across chunks the per-chunk states are
carried by a Python loop over the ``S / Q`` chunks, where the reference
runs a ``lax.scan``.  Everything in the SSD runs in float32.  Decode is
the O(1) recurrent update on a float32 ``(B, nh, hd, N)`` state.

Types follow the reference's promotion rules (JAX promotes a bfloat16
operand against a float32 one to float32; :func:`_mm` does the same for
a matmul, which in PyTorch needs one dtype).

Tensor parallelism (``ctx`` active, the reference's dist branch): the
projections are head-block structured — ``zproj``/``xproj``/``dtproj``
and the xs depthwise conv are column-parallel over whole SSD heads, the
B/C stream (``bcproj`` and its conv) is replicated (shared by every
head in the minimal SSD form), the per-head vectors are sliced to the
local heads (``local_block``), and ``out_proj`` is row-parallel.  Under
sequence parallelism the block gathers the sequence before the scan
(which needs all of S) and ``out_proj``'s reduce-scatter returns the
local block.  The decode step's TP form keeps a rank's heads in its
conv and SSM states and finishes ``out_proj`` with a psum.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import NULL_CTX


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX computes a dot
    of a bfloat16 and a float32 operand."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def init_ssm(d: int, expand: int, d_state: int, d_conv: int, head_dim: int,
             generator: Optional[torch.Generator], device="cpu",
             dtype=torch.float32, lead: Tuple[int, ...] = (),
             keep=None) -> Dict:
    """The reference's leaves: seven N(0, 0.02²) matrices from the
    generator, zero conv biases, and the deterministic per-head vectors
    ``A_log = log(linspace(1, 16, nh))``, ``D = 1``, ``dt_bias = 0``.
    ``lead`` prepends the stacked layer axis; vectors of a stacked layer
    are in ``dtype`` (the working copy ``cast_params`` makes of a tensor
    of two or more dimensions), an unstacked layer's stay float32.
    ``keep(name, full)`` → the part of each matrix to keep, as it is
    drawn (a rank's slice under TP; None keeps all); the vectors stay
    whole."""
    di = expand * d
    nh = di // head_dim
    vdt = dtype if lead else torch.float32

    def normal(name, *shape):
        t = torch.randn(lead + shape, generator=generator, dtype=dtype,
                        device=device)
        return (t if keep is None else keep(name, t)).mul_(0.02)

    def vec(values):
        return values.to(device=device, dtype=vdt).expand(
            lead + values.shape).clone()

    return {
        "zproj": normal("zproj", d, di),
        "xproj": normal("xproj", d, di),
        "bcproj": normal("bcproj", d, 2 * d_state),
        "dtproj": normal("dtproj", d, nh),
        "conv_x_w": normal("conv_x_w", d_conv, di),
        "conv_x_b": vec(torch.zeros(di)),
        "conv_bc_w": normal("conv_bc_w", d_conv, 2 * d_state),
        "conv_bc_b": vec(torch.zeros(2 * d_state)),
        "A_log": vec(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": vec(torch.ones(nh)),
        "dt_bias": vec(torch.zeros(nh)),
        "out_proj": normal("out_proj", di, d),
    }


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, then SiLU: seq (B, S, C), w
    (K, C); K unrolled adds, as the reference."""
    K, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = torch.zeros_like(seq)
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[k]
    return F.silu(out + b)


def _segsum(logdA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(Σ_{k=j+1..i} logdA_k) for j ≤ i else 0: (..., Q, Q).

    The upper triangle is masked to −inf before the exp, as the Mamba-2
    paper's minimal SSD code does.  The reference takes the exp of the
    whole difference and masks after: there ``Σ |logdA|`` over a chunk
    above ~88 overflows the upper triangle to inf, and its backward
    multiplies that inf by the mask's zero gradient, so mamba2-370m's
    256-token chunks give NaN gradients from the first step.  The
    values are the same; the gradients are wherever the reference's are
    finite."""
    Q = logdA.shape[-1]
    cs = torch.cumsum(logdA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                 device=logdA.device))
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_chunked(xbar: torch.Tensor,   # (B, S, nh, hd) = dt · x
                logdA: torch.Tensor,  # (B, S, nh)     = dt · A  (A < 0)
                Bc: torch.Tensor,     # (B, S, N)
                Cc: torch.Tensor,     # (B, S, N)
                chunk: int,
                h0: Optional[torch.Tensor] = None,  # (B, nh, hd, N)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan → (y (B, S, nh, hd), final state), float32."""
    B, S, nh, hd = xbar.shape
    N = Bc.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    c = S // chunk
    f32 = torch.float32
    xb = xbar.reshape(B, c, chunk, nh, hd).to(f32)
    la = logdA.reshape(B, c, chunk, nh).to(f32)
    Bb = Bc.reshape(B, c, chunk, N).to(f32)
    Cb = Cc.reshape(B, c, chunk, N).to(f32)

    # intra-chunk (dual, attention-like form)
    L = _segsum(la.transpose(-1, -2))  # (B, c, nh, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cb, Bb)  # (B, c, Q, Q)
    M = scores[:, :, None] * L
    y_in = torch.einsum("bchqk,bckhd->bcqhd", M, xb)

    # per-chunk summarized state: S_c = Σ_j decay_to_end_j · x̄_j ⊗ B_j
    cs = torch.cumsum(la, dim=2)  # (B, c, Q, nh)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)
    S_c = torch.einsum("bcqh,bcqhd,bcqn->bchdn", decay_end, xb, Bb)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B, c, nh)

    # inter-chunk recurrence over the c chunks (the reference's lax.scan)
    h = (torch.zeros((B, nh, hd, N), dtype=f32, device=xbar.device)
         if h0 is None else h0.to(f32))
    entering = []
    for i in range(c):
        entering.append(h)  # the state entering chunk i
        h = h * chunk_decay[:, i, :, None, None] + S_c[:, i]
    h_enter = torch.stack(entering, dim=1)  # (B, c, nh, hd, N)

    # contribution of the entering state within each chunk
    y_out = torch.einsum("bcqn,bchdn,bcqh->bcqhd", Cb, h_enter,
                         torch.exp(cs))
    return (y_in + y_out).reshape(B, S, nh, hd), h


def ssd_reference(xbar, logdA, Bc, Cc, h0=None):
    """Naive per-token recurrence, the oracle of the chunked form."""
    B, S, nh, hd = xbar.shape
    N = Bc.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((B, nh, hd, N), dtype=f32, device=xbar.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(S):
        dA = torch.exp(logdA[:, t].to(f32))  # (B, nh)
        h = h * dA[..., None, None] + torch.einsum(
            "bhd,bn->bhdn", xbar[:, t].to(f32), Bc[:, t].to(f32))
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cc[:, t].to(f32)))
    return torch.stack(ys, dim=1), h


def _head_params(params: Dict, nh: int, ctx):
    """The per-head vectors sliced to this rank's heads (a no-op when the
    projections are whole)."""
    return (ctx.local_block(params["A_log"], nh),
            ctx.local_block(params["D"], nh),
            ctx.local_block(params["dt_bias"], nh))


def _finish(out: torch.Tensor, params: Dict, cfg, ctx) -> torch.Tensor:
    """``out_proj``'s output: row-parallel (a rank's heads) → the
    reduce-scatter (a psum without SP); whole → the local block."""
    if ctx.active and params["out_proj"].shape[-2] != cfg.expand * cfg.d_model:
        return ctx.psum_scatter(out)
    return ctx.scatter_seq(out)


def ssm_forward(params: Dict, x: torch.Tensor, cfg,
                ctx=NULL_CTX) -> torch.Tensor:
    """Full-sequence Mamba-2 block (training, full forward); x (B, S, d),
    under SP the local sequence block.  The chunk is ``min(cfg.ssm_chunk,
    S)``, which must divide S."""
    x = ctx.gather_seq(x)  # gather before the scan: it needs all of S
    hd = cfg.ssm_head_dim
    z = _mm(x, params["zproj"])
    xs = _mm(x, params["xproj"])
    bc = _mm(x, params["bcproj"])   # replicated under TP
    dt = _mm(x, params["dtproj"])
    di = xs.shape[-1]
    nh = di // hd
    xs = _causal_conv(xs, params["conv_x_w"],
                      ctx.local_block(params["conv_x_b"], di))
    bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"])
    Bc, Cc = bc.chunk(2, dim=-1)
    A_log, D, dt_bias = _head_params(params, nh, ctx)
    xh = xs.reshape(*xs.shape[:2], nh, hd)
    dt = F.softplus(dt.to(torch.float32) + dt_bias)
    A = -torch.exp(A_log)
    xbar = xh.to(torch.float32) * dt[..., None]
    logdA = dt * A
    y, _ = ssd_chunked(xbar, logdA, Bc, Cc,
                       chunk=min(cfg.ssm_chunk, x.shape[1]))
    y = y + D[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = y * F.silu(z)  # gated
    return _finish(_mm(y, params["out_proj"]), params, cfg, ctx)


def ssm_init_cache(cfg, batch: int, lead: Tuple[int, ...] = (),
                   device="cpu", tp: int = 1) -> Dict:
    """Zero decode state, float32 whatever the model dtype (as the
    reference's: a long exact handoff must not accumulate bf16 error);
    ``lead`` prepends the stacked layer axis.  Under TP (``tp``) a rank's
    heads: ``h`` (B, nh/tp, hd, N) and ``conv`` over its di/tp channels
    and the replicated B/C stream."""
    di = cfg.expand * cfg.d_model // tp
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.d_state
    f32 = torch.float32
    return {
        "h": torch.zeros(lead + (batch, nh, cfg.ssm_head_dim, cfg.d_state),
                         dtype=f32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, conv_dim),
                            dtype=f32, device=device),
    }


def ssm_decode_step(params: Dict, x: torch.Tensor, cache: Dict, cfg,
                    ctx=NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """One token: x (B, 1, d) → (out (B, 1, d), new cache); under TP a
    rank's heads (its cache holds their states), ``out_proj`` psum'd."""
    hd = cfg.ssm_head_dim
    f32 = torch.float32
    z = _mm(x, params["zproj"])
    xs = _mm(x, params["xproj"])
    bc = _mm(x, params["bcproj"])
    dt = _mm(x, params["dtproj"])
    di = xs.shape[-1]
    nh = di // hd
    conv_in = torch.cat([xs, bc], dim=-1)  # (B, 1, di + 2N)
    hist = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)], 1)
    w = torch.cat([params["conv_x_w"], params["conv_bc_w"]], dim=-1)
    b = torch.cat([ctx.local_block(params["conv_x_b"], di),
                   params["conv_bc_b"]], dim=-1)
    K = w.shape[0]
    win = hist[:, -K:]
    conv = torch.einsum("bkc,kc->bc", win,
                        w.to(torch.promote_types(win.dtype, w.dtype)))
    conv_out = F.silu(conv + b)[:, None, :]
    xs, Bc, Cc = torch.split(conv_out, [di, cfg.d_state, cfg.d_state], -1)
    A_log, D, dt_bias = _head_params(params, nh, ctx)
    xh = xs.reshape(xs.shape[0], nh, hd).to(f32)
    dt1 = F.softplus(dt[:, 0].to(f32) + dt_bias)  # (B, nh)
    A = -torch.exp(A_log)
    dA = torch.exp(dt1 * A)
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bhd,bn->bhdn", xh * dt1[..., None], Bc[:, 0].to(f32))
    y = torch.einsum("bhdn,bn->bhd", h, Cc[:, 0].to(f32))
    y = y + D[None, :, None] * xh
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = y * F.silu(z)
    out = _mm(y, params["out_proj"])
    if ctx.active and params["out_proj"].shape[-2] != cfg.expand * cfg.d_model:
        out = ctx.psum(out)
    return out, {"h": h, "conv": hist[:, 1:]}
