"""The plain reference model: a decoder-only transformer in float32.

Written from the architecture's description, for the layout of
``portbench.weights.param_shapes``: token embedding; per layer an RMS
norm (eps 1e-6), grouped-query causal attention with rotary positions
(the rotate-half form, inverse frequencies ``θ^(-2i/Dh)``, scores scaled
by ``Dh^-½``, query head ``h`` reading key/value head ``h // (H / Kv)``),
a residual, an RMS norm and either a SwiGLU MLP or a top-k mixture of
experts, a residual; a final RMS norm and the vocabulary head (the
embedding's transpose when tied).  The expert layer routes by the
softmax of the router's logits, keeps the top ``k`` renormalized (ties
to the lower expert), gives each expert ``int(max(1, cf·N·k/E))`` slots
filled in token order (later entries are dropped), and adds the Switch
load-balancing loss ``E · Σ_e f_e · P_e``.  No kernel, no cache, no
batching tricks: every matmul is a plain ``@`` in float32 with TF32 off.

``quant="fp8"`` runs every projection's operands through e4m3 with one
scale a tensor (forward, and in training the backward's too): the
precision one step below the configuration's bfloat16, the control that
must come out not correct.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
AUX_WEIGHT = 0.01


@contextlib.contextmanager
def exact_f32():
    """Matmuls and convolutions in full float32 (TF32 off), restored
    after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at one scale (max |t| → 448)."""
    amax = t.detach().abs().amax().float()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g)
        gx = gq @ wq.transpose(-1, -2)
        if wq.dim() == 2:  # one matrix for every row of x
            gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:  # a matrix for each batch of x (the experts)
            gw = xq.transpose(-1, -2) @ gq
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, quant: str = "") -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        return _Fp8Matmul.apply(x, w)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + EPS) * scale.float()


def rope(S: int, Dh: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                        device=device) / Dh))
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()  # (S, Dh/2)


def rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x (B, S, heads, Dh)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def attention(Wl, h, m, cs, quant):
    B, S, _ = h.shape
    H, Kv, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = linear(h, Wl["attn.wq"], quant).view(B, S, H, Dh)
    k = linear(h, Wl["attn.wk"], quant).view(B, S, Kv, Dh)
    v = linear(h, Wl["attn.wv"], quant).view(B, S, Kv, Dh)
    q, k = rotate(q, *cs), rotate(k, *cs)
    G = H // Kv
    k = k.repeat_interleave(G, dim=2)  # head h reads kv head h // G
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return linear(o.reshape(B, S, H * Dh), Wl["attn.wo"], quant)


def mlp(Wl, h, quant):
    return linear(F.silu(linear(h, Wl["mlp.wg"], quant))
                  * linear(h, Wl["mlp.wu"], quant), Wl["mlp.wd"], quant)


def moe(Wl, h, m, quant) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, aux) of the expert layer over all ``B·S`` tokens of ``h``:
    each expert's kept tokens gathered into its rows of an ``(E, cap,
    d)`` buffer (unused rows zero), the experts' SwiGLU FFNs as one
    batched matmul, each kept entry's output weighted and added back to
    its token."""
    B, S, d = h.shape
    N, E, k = B * S, m["n_experts"], m["top_k"]
    xf = h.reshape(N, d)
    probs = torch.softmax(linear(xf, Wl["moe.router"], quant), -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, m["capacity_factor"] * N * k / E))
    flat_e = top_e.reshape(-1)  # token-major (token, choice) entries
    counts = torch.bincount(flat_e, minlength=E)
    aux = E * torch.sum(counts.float() / (N * k) * probs.mean(0))
    entry = torch.full((E, cap), N * k, dtype=torch.long, device=h.device)
    with torch.no_grad():
        for e in range(E):  # the first ``cap`` entries of each expert
            idx = torch.nonzero(flat_e == e).squeeze(1)[:cap]
            entry[e, :idx.numel()] = idx
    tok = torch.div(entry, k, rounding_mode="floor")  # N: an unused row
    x_pad = torch.cat([xf, xf.new_zeros(1, d)])
    buf = x_pad[tok]  # (E, cap, d)
    hid = F.silu(linear(buf, Wl["moe.we_g"], quant)) \
        * linear(buf, Wl["moe.we_u"], quant)
    out = linear(hid, Wl["moe.we_d"], quant)
    w = torch.cat([top_p.reshape(-1), top_p.new_zeros(1)])[entry]
    y = torch.zeros(N + 1, d, device=h.device).index_add(
        0, tok.reshape(-1), (out * w[..., None]).reshape(-1, d))
    return y[:N].reshape(B, S, d), aux


def layer(Wl, x, m, cs, quant):
    x = x + attention(Wl, rms_norm(x, Wl["norm1.scale"]), m, cs, quant)
    h = rms_norm(x, Wl["norm2.scale"])
    if m.get("n_experts", 0):
        out, aux = moe(Wl, h, m, quant)
    else:
        out, aux = mlp(Wl, h, quant), torch.zeros((), device=x.device)
    return x + out, aux


def per_layer(W: Dict[str, torch.Tensor], m: Dict):
    """Each layer's weights (views of the stacked leaves, unbound once a
    forward, so the backward stacks each leaf's gradient once)."""
    g = "groups.p0."
    stacked = {k[len(g):]: W[k].unbind(0) for k in W if k.startswith(g)}
    return [{k: v[l] for k, v in stacked.items()}
            for l in range(m["n_layers"])]


def hidden(W: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
           quant: str = "", remat: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-normed hidden states (B, S, d), summed aux) of ``tokens``."""
    x = W["embed.table"].float()[tokens]
    cs = rope(tokens.shape[1], m["head_dim"], m["rope_theta"], x.device)
    aux = torch.zeros((), device=x.device)
    for Wl in per_layer(W, m):
        if remat:
            x, a = checkpoint(layer, Wl, x, m, cs, quant,
                              use_reentrant=False)
        else:
            x, a = layer(Wl, x, m, cs, quant)
        aux = aux + a
    return rms_norm(x, W["final_norm.scale"]), aux


def head_weight(W, m) -> torch.Tensor:
    return W["embed.table"].T if m.get("tie_embeddings", False) \
        else W["head.w"]


def logits(W, m, x, quant: str = "") -> torch.Tensor:
    return linear(x, head_weight(W, m), quant)


def nll(W, m, x, targets, quant: str = "") -> torch.Tensor:
    """Per-token negative log-likelihood (B, S)."""
    z = logits(W, m, x, quant)
    return torch.logsumexp(z, -1) - torch.gather(
        z, -1, targets[..., None]).squeeze(-1)


def objective(W, m, tokens, targets, weights, denom: float,
              aux_coef: float = 0.0, quant: str = "",
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(Σ nll·w / denom + aux_coef · aux, the loss term, aux)."""
    x, aux = hidden(W, m, tokens, quant, remat)
    loss = (nll(W, m, x, targets, quant) * weights).sum() / denom
    return loss + aux_coef * aux, loss.detach(), aux.detach()


def served_logits(W, m, tokens: torch.Tensor, first: int,
                  quant: str = "") -> torch.Tensor:
    """f32 logits (n, V) at positions ``first..S-1`` of one row."""
    x, _ = hidden(W, m, tokens[None], quant)
    return logits(W, m, x[0, first:], quant)
