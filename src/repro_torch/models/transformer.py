"""The transformer of the port (serving and training).

PyTorch counterpart of ``repro.models.transformer`` for models whose
layers are "global"/"local" attention with a dense MLP or a mixture of
experts (``models.moe``), "ssm" (Mamba-2 SSD, ``models.ssm``) or
"recurrent" (RG-LRU with an MLP, ``models.rglru``); the encoder–decoder
(whisper: a bidirectional "enc" stack over precomputed frames, and a
cross-attention block in every decoder layer) and the VLM backbone
(qwen2-vl: M-RoPE over (3, B, S) positions, precomputed visual
embeddings in the first positions):

  * params are nested dicts of tensors keyed like the reference pytree
    (``embed/table``, ``groups/p0/attn/wq`` …); every layer tensor of a
    pattern position is stacked along a leading layer axis, and a
    Python loop indexes the stack where the reference runs ``lax.scan``,
  * attention goes through ``kernels.ops``: the full sequence (self-,
    encoder and cross-attention) through the flash-attention kernel,
    each decode step through the decode-attention kernel — the cross
    block too, over the static cross cache that :func:`fill_cross_cache`
    fills once per request (plain versions for CPU tensors),
  * the decode cache is updated in place (see ``decode_step``); the
    recurrent layers' states (SSD ``h``/``conv``, RG-LRU ``h``/``conv``)
    exist only there and stay float32, as the reference's,
  * training differentiates ``loss_and_metrics`` with autograd: the
    params are float32 leaves, ``cast_params`` makes the working copy
    inside the graph (so gradients come back float32), self-attention
    goes through ``models.attention.FlashAttention`` (the flash kernel
    forward, the reference's recompute backward) and each layer is
    rematerialized with ``torch.utils.checkpoint``, as ``_remat_wrap``
    does with ``jax.checkpoint``; under ``remat_policy=
    "save_block_outputs"`` a layer keeps its sublayers' outputs after
    their finishing collective and its recompute runs none of those
    (``dist.sharding.BlockOutputs``, the reference's ``_ckpt_name``
    tags).  The pipeline's pieces are
    :func:`embed_tokens`, :func:`apply_groups` over a stage's block of
    the group stacks and :func:`head_loss_terms` (the rest layers, the
    head and the cross-entropy), as the reference splits them.

Tensor parallelism threads a :class:`~repro_torch.dist.sharding.ShardCtx`
(``ctx``) through every layer kind, as the reference's
``models.transformer`` threads it: column-parallel q/k/v and MLP
in-projections, row-parallel ``wo``/``wd``/``w2`` finished by
``ctx.psum_scatter`` (a psum without SP), K/V replicated when
``n_kv_heads`` does not divide the degree (each rank then attends with
the one KV head of its Q block), a d-sharded embedding gathered at the
use site, an untied head giving vocab-parallel logits (decoded by the
cross-entropy's one fused psum), a tied one row-parallel through
``ctx.local_block``; the MoE layer expert-parallel, the SSM and RG-LRU
blocks over a rank's heads or channels (``models.moe``, ``models.ssm``,
``models.rglru``), whisper's encoder and cross block at a rank's heads
with a per-rank cross cache.  Under sequence parallelism
(``ctx.seq_shard``) the residual stream between blocks is this rank's
sequence block: the embedding is scattered (``scatter_seq``), every
block gathers the sequence before its column-parallel in-projections
(``gather_seq``) and reduce-scatters its row-parallel output, norms and
residuals run on the local block, the head gathers the sequence back,
and the encoder runs without SP (``ctx.no_sp()``).  Every decision is a
comparison of a local shape with the config's; inactive (tp 1) every
``ctx`` call is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    NULL_CTX,
    BlockOutputs,
    ShardCtx,
    shard_axis,
    stage_layer_ranges,
    validate_pp,
    validate_tp,
)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.ssm import _mm

PyTree = Any

AUX_WEIGHT = 0.01  # MoE load-balancing weight (the reference's; dense: aux = 0)


def _torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


ATTENTION_KINDS = ("global", "local")


def _check_supported(cfg: ModelConfig) -> None:
    unknown = set(cfg.block_pattern) - {*ATTENTION_KINDS, "ssm", "recurrent"}
    if unknown:
        raise ValueError(f"unknown layer kinds {sorted(unknown)}")


def local_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """K/V heads a rank attends with: its share when ``n_kv_heads``
    divides ``tp``, else one (the replicated-KV fallback slices the head
    of its Q block; MQA keeps its one head)."""
    Kv = cfg.n_kv_heads
    if tp <= 1:
        return Kv
    return Kv // tp if Kv % tp == 0 else 1


def _has_attention(cfg: ModelConfig) -> bool:
    return any(k in ATTENTION_KINDS for k in cfg.block_pattern)


def _map_tensors(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_len(tree: PyTree) -> int:
    """The leading (stacked-layer) dim of a layer stack."""
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree.shape[0]


def _index(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked layer dict, as views (no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------
# normalization
# ----------------------------------------------------------------------
def _init_norm(cfg: ModelConfig, shape, device,
               dtype=torch.float32) -> Dict:
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def _norm(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """RMS (or layer) norm in f32, eps 1e-6, as the reference computes
    it; the fused ``F.rms_norm``/``F.layer_norm`` keep the serving
    step's launch count down."""
    xf = x.to(torch.float32)
    shape = (x.shape[-1],)
    if "bias" in p:
        out = F.layer_norm(xf, shape, eps=1e-6) * p["scale"] + p["bias"]
    else:
        out = F.rms_norm(xf, shape, eps=1e-6) * p["scale"]
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=None, tp: int = 1,
                rank: int = 0, pp: int = 1, stage: int = 0) -> PyTree:
    """Random weights N(0, 0.02²), laid out as the reference's pytree.

    Serving allocates the cast working copy directly, as
    ``cast_params`` would make it of an f32 master copy without holding
    that copy too (32 GB for llama3-8b): every tensor of two or more
    dimensions (the matrices and the layer-stacked norm scales) in
    ``dtype`` (default ``cfg.dtype``), the final norm scale in float32.
    Training passes ``dtype=torch.float32``: the f32 master copy.
    ``generator`` must live on ``device``; None seeds one with 0.
    Each layer is built by kind as the reference's ``_init_layer``:
    ``attn``, ``ssm`` or ``rglru``, then (but for "ssm") ``norm2`` with
    ``moe`` (experts of width ``d_ff``) where ``cfg.moe_at(k)`` or
    ``mlp`` (width ``d_ff_dense or d_ff``).  The recurrent layers'
    deterministic vectors (``A_log``, ``D``, ``dt_bias``; ``lam``,
    ``b_a``, ``b_x``) follow the same dtype rule: in ``dtype`` when
    stacked, float32 in a ``rest`` layer.  An encoder–decoder config
    adds ``norm_x`` and ``xattn`` to every layer and ``encoder`` (its
    ``enc_norm`` and ``groups.p0``, ``n_enc_layers`` stacked "enc"
    layers).  The encoder's layers carry ``norm_x``/``xattn`` too, as
    the reference's do (its ``stack_layers`` closes over ``cross``):
    never used, their gradients are zero, but the flat keys and an
    optimizer's decay of them match the reference's.

    With ``tp > 1`` the result is rank ``rank``'s slices
    (``dist.sharding.shard_axis``): each full leaf is drawn in turn, as
    at tp 1, and only its slice kept, so one seed gives the slices of
    the tp-1 weights and the peak is one full leaf.  With ``pp > 1`` the
    ``groups`` stacks keep stage ``stage``'s block of their leading axis
    (``dist.sharding.stage_layer_ranges``) the same way, so one seed gives
    the same global weights at every (pp, tp).  ``device="meta"`` gives
    the shapes alone (no generator).
    """
    if tp > 1:
        validate_tp(cfg, tp)
    if pp > 1:
        validate_pp(cfg, pp)
    _check_supported(cfg)
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _torch_dtype(dtype or cfg.dtype)
    d, V, H, Kv, Dh = (cfg.d_model, cfg.vocab, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    ff = cfg.d_ff_dense or cfg.d_ff

    P = len(cfg.block_pattern)
    n_groups, n_rest = cfg.n_layers // P, cfg.n_layers % P
    per_stage = n_groups // max(pp, 1)
    first_group = stage_layer_ranges(cfg, pp)[stage][0] // P

    def stage_block(t):
        """Stage ``stage``'s block of a full group stack's leading axis."""
        if pp <= 1 or t.shape[0] != n_groups:
            return t
        return t.narrow(0, first_group, per_stage).clone()

    def keep(name, t, staged=False):
        """This rank's slice of a full leaf as it is drawn."""
        ax = shard_axis(name, tuple(t.shape), cfg, tp)
        if ax is not None:
            n = t.shape[ax] // tp
            t = t.narrow(ax, rank * n, n).clone()
        return stage_block(t) if staged else t

    def normal(name, *shape, staged=False):
        t = torch.randn(shape, generator=generator, dtype=dt, device=device)
        return keep(name, t, staged).mul_(0.02)

    def layers(lead: Tuple[int, ...], kind: str, moe: bool,
               staged: bool = False) -> Dict:
        """One pattern position's layers, stacked over ``lead``; a
        ``staged`` stack keeps the stage's block of every leaf."""
        def kept(name, t):
            return keep(name, t, staged)

        def draw(name, *shape):
            return normal(name, *shape, staged=staged)

        def attn(lead):
            return {"wq": draw("wq", *lead, d, H * Dh),
                    "wk": draw("wk", *lead, d, Kv * Dh),
                    "wv": draw("wv", *lead, d, Kv * Dh),
                    "wo": draw("wo", *lead, H * Dh, d)}

        ndt = dt if lead else torch.float32
        p: Dict[str, Any] = {
            "norm1": _init_norm(cfg, lead + (d,), device, ndt)}
        if kind in ATTENTION_KINDS or kind == "enc":
            p["attn"] = attn(lead)
        elif kind == "ssm":
            p["ssm"] = ssm_lib.init_ssm(
                d, cfg.expand, cfg.d_state, cfg.d_conv, cfg.ssm_head_dim,
                generator, device, dt, lead, kept)
        else:
            p["rglru"] = rglru_lib.init_rglru_block(
                d, cfg.lru_width or d, cfg.d_conv, generator, device, dt,
                lead, kept)
        if cfg.is_encdec:
            p["norm_x"] = _init_norm(cfg, lead + (d,), device, ndt)
            p["xattn"] = attn(lead)
        if cfg.d_ff > 0 and kind != "ssm":
            p["norm2"] = _init_norm(cfg, lead + (d,), device, ndt)
            if moe:
                p["moe"] = moe_lib.init_moe(
                    d, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts,
                    generator, device, dt, lead, kept)
            elif cfg.mlp == "swiglu":
                p["mlp"] = {"wg": draw("wg", *lead, d, ff),
                            "wu": draw("wu", *lead, d, ff),
                            "wd": draw("wd", *lead, ff, d)}
            else:
                p["mlp"] = {"w1": draw("w1", *lead, d, ff),
                            "w2": draw("w2", *lead, ff, d)}
        # the deterministic leaves (norms, the recurrences' vectors) are
        # made whole: the stage's block of them too
        return _map_tensors(stage_block, p) if staged else p

    params: Dict[str, Any] = {
        "embed": {"table": normal("table", V, d)},
        "final_norm": _init_norm(cfg, (d,), device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": normal("w", d, V)}
    params["groups"] = {f"p{k}": layers((n_groups,), cfg.block_pattern[k],
                                        cfg.moe_at(k), staged=pp > 1)
                        for k in range(P)}
    if n_rest:
        params["rest"] = {f"r{k}": layers((), cfg.block_pattern[k],
                                          cfg.moe_at(k))
                          for k in range(n_rest)}
    if cfg.is_encdec:
        params["encoder"] = {
            "enc_norm": _init_norm(cfg, (d,), device),
            "groups": {"p0": layers((cfg.n_enc_layers,), "enc",
                                    cfg.is_moe)}}
    return params


# ----------------------------------------------------------------------
# layer application (full sequence)
# ----------------------------------------------------------------------
def _split_heads(x, n, Dh):
    return x.reshape(*x.shape[:-1], n, Dh)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """Rotary tables for ``positions`` ((B, S), or (3, B, S) for M-RoPE),
    computed once per forward/step and shared by every layer (the
    reference recomputes them per ``apply_rope`` call; the values are
    the same)."""
    return attn_lib.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                cfg.mrope_sections)


def _kv_slice(ctx: ShardCtx, cfg: ModelConfig, H: int, Kv: int) -> bool:
    """The replicated-KV GQA fallback (TP with ``n_kv_heads`` ∤ tp):
    every rank computes all KV heads, but its Q block lies inside ONE KV
    group (``validate_tp``: tp a multiple of ``n_kv_heads``), so it keeps
    that head and the local Q→KV pairing matches the unsharded model."""
    return (ctx.active and H != cfg.n_heads and Kv == cfg.n_kv_heads
            and Kv > 1)


def _kv_head(x: torch.Tensor, ctx: ShardCtx, Kv: int) -> torch.Tensor:
    """(…, Kv, Dh) → this rank's KV head (…, 1, Dh)."""
    return x.narrow(-2, ctx.axis_index() * Kv // ctx.tp, 1)


def _attn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                kv_source: Optional[torch.Tensor] = None,
                ctx: ShardCtx = NULL_CTX
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention block; returns (output, (k, v) for caching).

    Self-attention ("global"/"local": causal; "enc": bidirectional)
    rotates q and k with ``rope`` (None: no rotation, an encoder with
    ``rope_theta`` 0).  With ``kv_source`` (the encoder's output) it is
    cross-attention: k and v are its projections, nothing is rotated,
    and every query sees every frame.  The whole sequence is the
    flash-attention kernel's function, masked by index whatever
    ``cfg.flash`` says: the reference's two branches compute the same
    values over ``arange`` positions; over others (M-RoPE's vision
    layout) only its flash branch masks by index (ROADMAP.md §3).

    Under TP (``ctx`` active) the heads are this rank's block
    (``local_head_counts``) and the row-parallel out-projection is
    finished by one psum over "model"; under SP ``x`` is the local
    sequence block, gathered first, and the finish reduce-scatters back
    to it (the cached k/v are the whole sequence's).
    """
    x = ctx.gather_seq(x)
    B, S, _ = x.shape
    Dh = cfg.head_dim
    H, Kv = attn_lib.local_head_counts(p, Dh)
    src = x if kv_source is None else kv_source
    q = _split_heads(x @ p["wq"], H, Dh)
    k = _split_heads(src @ p["wk"], Kv, Dh)
    v = _split_heads(src @ p["wv"], Kv, Dh)
    if _kv_slice(ctx, cfg, H, Kv):
        k, v = _kv_head(k, ctx, Kv), _kv_head(v, ctx, Kv)
    if kv_source is None and rope is not None:
        q, k = attn_lib.rotate(q, *rope), attn_lib.rotate(k, *rope)
    causal = kind in ATTENTION_KINDS and kv_source is None
    window = cfg.window if kind == "local" else 0
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        out = attn_lib.flash_attention(q, k, v, causal, window,
                                       cfg.logit_softcap, cfg.attn_chunk)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.logit_softcap)
    out = out.reshape(B, S, H * Dh) @ p["wo"]
    if ctx.active and H != cfg.n_heads:
        out = ctx.psum_scatter(out)  # row-parallel out-projection
    else:
        out = ctx.scatter_seq(out)  # whole heads: back to the local block
    return out, (k, v)


def _mlp_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
               ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Matmuls in the operands' promoted dtype: after a ``rest`` recurrent
    layer, whose float32 biases promote the residual stream as in the
    reference, a bf16 model's later layers run in float32.  Under TP the
    in-projections are column-parallel and the down-projection
    row-parallel, finished by one psum (under SP the sequence is gathered
    first and the finish reduce-scatters)."""
    x = ctx.gather_seq(x)
    if cfg.mlp == "swiglu" and "wg" in p:
        out = _mm(F.silu(_mm(x, p["wg"])) * _mm(x, p["wu"]), p["wd"])
        down = p["wd"]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        out = _mm(F.gelu(_mm(x, p["w1"]), approximate="tanh"), p["w2"])
        down = p["w2"]
    if ctx.active and down.shape[-2] != (cfg.d_ff_dense or cfg.d_ff):
        return ctx.psum_scatter(out)  # row-parallel down-projection
    return ctx.scatter_seq(out)


def _ffn_apply(p: Dict, h: torch.Tensor, cfg: ModelConfig,
               ctx: ShardCtx = NULL_CTX
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward half → (output, MoE aux loss or None)."""
    if "moe" in p:
        return moe_lib.moe_ffn(
            p["moe"], h, cfg.top_k, cfg.capacity_factor, ctx=ctx,
            shared_width=cfg.n_shared_experts * cfg.d_ff,
            n_experts=cfg.n_experts)
    return _mlp_apply(p["mlp"], h, cfg, ctx), None


def _layer_out(p: Dict, x: torch.Tensor, kind: str, cfg: ModelConfig,
               rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
               enc_out: Optional[torch.Tensor] = None,
               ctx: ShardCtx = NULL_CTX
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer's (output, aux) without its cache entry (the training
    body)."""
    x, _, aux = _layer_apply(p, x, kind, cfg, rope, enc_out, ctx)
    return x, aux


def _layer_apply(p: Dict, x: torch.Tensor, kind: str, cfg: ModelConfig,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 enc_out: Optional[torch.Tensor] = None,
                 ctx: ShardCtx = NULL_CTX
                 ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """Returns (x_out, cache_entry, aux_loss): aux is the MoE layer's
    load-balancing loss, None for a dense layer.  The cache entry is the
    attention layer's K/V; ``()`` for "ssm"/"recurrent", whose states
    only the decode path builds.  A decoder layer of an encoder–decoder
    model attends to ``enc_out`` after its self-attention (``norm_x``,
    then ``xattn``)."""
    h = _norm(p["norm1"], x)
    cache_entry: Any = ()
    # the sublayers whose outputs the reference tags "block_out"
    block = dataclasses.replace(ctx, block_out=True) \
        if cfg.remat_policy == "save_block_outputs" and ctx.active else ctx
    if kind in ATTENTION_KINDS or kind == "enc":
        out, (k, v) = _attn_apply(p["attn"], h, cfg, kind, rope, ctx=block)
        cache_entry = {"k": k.reshape(*k.shape[:2], -1),
                       "v": v.reshape(*v.shape[:2], -1)}
    elif kind == "ssm":
        out = ssm_lib.ssm_forward(p["ssm"], h, cfg, block)
    else:
        out = rglru_lib.rglru_block_forward(p["rglru"], h, cfg, block)
    x = x + out
    if "xattn" in p and enc_out is not None:
        out, _ = _attn_apply(p["xattn"], _norm(p["norm_x"], x), cfg,
                             "cross", None, kv_source=enc_out, ctx=ctx)
        x = x + out
    aux = None
    if "norm2" in p:
        out, aux = _ffn_apply(p, _norm(p["norm2"], x), cfg, block)
        x = x + out
    return x, cache_entry, aux


def _remat_context(cfg: ModelConfig):
    """The ``context_fn`` of a layer's checkpoint: ``"full"`` recomputes
    everything; ``"save_block_outputs"`` keeps the sublayers' outputs
    after their finishing collective (:class:`BlockOutputs`).  While a
    profiler records, the recompute runs under ``obs.recompute()``."""
    policy = BlockOutputs().contexts \
        if cfg.remat_policy == "save_block_outputs" else noop_context_fn
    if not obs.recording():
        return policy

    def contexts():
        fwd, rec = policy()
        return fwd, _recomputing(rec)

    return contexts


@contextlib.contextmanager
def _recomputing(rec):
    with obs.recompute(), rec:
        yield


# ----------------------------------------------------------------------
# full forward (prefill)
# ----------------------------------------------------------------------
def cast_params(params: PyTree, cfg: ModelConfig) -> PyTree:
    """Working copy: float32 tensors of two or more dimensions in
    ``cfg.dtype`` (the reference's rule; vectors stay f32).  No copy for
    tensors already in place — the serving weights from ``init_params``
    are."""
    tgt = _torch_dtype(cfg.dtype)

    def cast(a):
        if isinstance(a, dict):
            return {k: cast(v) for k, v in a.items()}
        if a.ndim >= 2 and a.dtype == torch.float32 and tgt != a.dtype:
            return a.to(tgt)
        return a

    return cast(params)


def _embed(params, cfg, tokens, ctx: ShardCtx = NULL_CTX):
    """Row lookup.  ``F.embedding`` rather than ``table[tokens]``: the
    indexing backward accumulates repeated ids in a thread-dependent
    order on the CPU, and kill/resume must repeat a run bit for bit;
    ``F.embedding``'s backward sums them in a fixed order on the CPU and
    on the card.  Under TP the table is d-sharded: each rank looks up
    its feature block and the blocks are gathered back to full width
    (the gather's transpose gives each rank its block's gradient)."""
    table = params["embed"]["table"].to(_torch_dtype(cfg.dtype))
    x = F.embedding(tokens, table)
    if ctx.active and table.shape[-1] != cfg.d_model:
        x = ctx.all_gather(x, axis=-1)
    return x


class _MatmulF32(torch.autograd.Function):
    """``x2 @ w`` of 16-bit operands accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32`` dot).  The backward takes
    the f32 cotangent down to the operands' dtype, as that dot's
    transpose returns cotangents in the operands' dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g


def _matmul_f32(x, w, cfg):
    """The vocab matmul accumulated and returned in f32 without an f32
    copy of the weights (on the card, and on ``meta``, the dry run's
    stand-in for it; the CPU has no such matmul)."""
    x = x.to(_torch_dtype(cfg.dtype))
    if w.dtype == torch.float32:
        return x @ w
    if w.is_cuda or w.is_meta:
        x2 = x.reshape(-1, x.shape[-1])
        out = _MatmulF32.apply(x2, w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _unembed(params, cfg, x, ctx: ShardCtx = NULL_CTX):
    """Final norm and the vocab matmul → f32 logits.  Under TP a tied
    head is the transposed d-sharded table, row-parallel: this rank's
    d-block of x times its rows, psum'd (full-vocab logits); an untied
    head (d, V) is column-parallel: vocab-parallel local logits, which
    the cross-entropy and the greedy argmax decode.  Under SP the norm
    runs on the local sequence block and the head on the gathered
    sequence."""
    x = ctx.gather_seq(_norm(params["final_norm"], x))
    if cfg.tie_embeddings:
        w = params["embed"]["table"].T
        if ctx.active and w.shape[0] != cfg.d_model:
            return ctx.psum(
                _matmul_f32(ctx.local_block(x, w.shape[0]), w, cfg))
        return _matmul_f32(x, w, cfg)
    return _matmul_f32(x, params["head"]["w"], cfg)


def _group_items(groups, cfg):
    """(params, kind, group key, layer index) of a ``groups`` stack in
    model order: the whole stack or a stage's block of it (the loop runs
    over whatever leading dim the stacks carry)."""
    P = len(cfg.block_pattern)
    for l in range(_stack_len(groups["p0"])):
        for k in range(P):
            yield (_index(groups[f"p{k}"], l), cfg.block_pattern[k],
                   ("groups", f"p{k}"), l)


def _rest_items(params, cfg):
    """(params, kind, key, None) of the remainder layers."""
    for k in range(cfg.n_layers % len(cfg.block_pattern)):
        yield (params["rest"][f"r{k}"], cfg.block_pattern[k],
               ("rest", f"r{k}"), None)


def _layers(params, cfg):
    """(params, kind, group key, layer index or None) in model order."""
    yield from _group_items(params["groups"], cfg)
    yield from _rest_items(params, cfg)


def _run_layers(items, x, cfg, rope, enc_out, ctx, auxes, cache=None):
    """Apply ``items`` (:func:`_group_items` / :func:`_rest_items`) to
    ``x``, each layer rematerialized under autograd unless a ``cache`` is
    filled; the MoE layers' aux losses are appended to ``auxes``."""
    remat = _remat(cfg) and cache is None
    for lp, kind, (part, key), l in items:
        if remat:
            x, aux = checkpoint(_layer_out, lp, x, kind, cfg, rope, enc_out,
                                ctx, use_reentrant=False,
                                context_fn=_remat_context(cfg))
        else:
            x, entry, aux = _layer_apply(lp, x, kind, cfg, rope, enc_out,
                                         ctx)
        if aux is not None:
            auxes.append(aux)
        if cache is not None:
            if l is None:
                cache[part][key] = entry
            elif kind in ATTENTION_KINDS:
                cache[part][key]["k"][l] = entry["k"]
                cache[part][key]["v"][l] = entry["v"]
    return x


def _aux_total(auxes, x) -> torch.Tensor:
    return (torch.stack(auxes).sum() if auxes else
            torch.zeros((), dtype=torch.float32, device=x.device))


def apply_groups(groups: PyTree, cfg: ModelConfig, x: torch.Tensor,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 enc_out: Optional[torch.Tensor] = None,
                 ctx: ShardCtx = NULL_CTX
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``groups`` stacks (cast) over ``x`` → ``(x, their summed
    aux)``: the whole stack, or a stage's block of it (pipeline
    parallelism: leading dim ``G / pp``), as the reference's
    ``_apply_groups``.  ``rope`` is :func:`rope_of`'s."""
    auxes: list = []
    x = _run_layers(_group_items(groups, cfg), x, cfg, rope, enc_out, ctx,
                    auxes)
    return x, _aux_total(auxes, x)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode_frames(params: PyTree, cfg: ModelConfig,
                  enc_frames: torch.Tensor,
                  ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """The whisper encoder over precomputed frontend frames (B, T_enc,
    d) → its output (B, T_enc, d); ``params`` must already be cast.

    Frames in ``cfg.dtype``, positions ``arange(T_enc)`` (RoPE unless
    ``rope_theta`` is 0), bidirectional "enc" layers, each
    rematerialized under autograd, then ``enc_norm``.  Under TP a rank's
    heads and MLP block; never sequence-sharded (``ctx.no_sp()``):
    ``enc_len`` need not divide tp, and cross-attention reads all of it.
    """
    ctx = ctx.no_sp()
    B, T = enc_frames.shape[:2]
    x = enc_frames.to(_torch_dtype(cfg.dtype))
    rope = None
    if cfg.rope_theta > 0:
        pos = torch.arange(T, device=x.device).expand(B, T)
        rope = attn_lib.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    stack = params["encoder"]["groups"]["p0"]
    for l in range(cfg.n_enc_layers):
        lp = _index(stack, l)
        if _remat(cfg):
            x, _ = checkpoint(_layer_out, lp, x, "enc", cfg, rope, None,
                              ctx, use_reentrant=False,
                              context_fn=_remat_context(cfg))
        else:
            x = _layer_apply(lp, x, "enc", cfg, rope, ctx=ctx)[0]
    return _norm(params["encoder"]["enc_norm"], x)


def embed_tokens(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 visual_embeds: Optional[torch.Tensor] = None,
                 ctx: ShardCtx = NULL_CTX
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding, the VLM frontend and the default positions → ``(x,
    positions)``; ``params`` must already be cast.  ``visual_embeds``
    (B, n_vis, d) replace the first ``n_vis`` embedded positions; the
    default positions are ``arange(S)`` per row, broadcast to (3, B, S)
    for an M-RoPE config.  Under SP ``x`` is this rank's sequence block
    (the positions stay whole: blocks gather before attending)."""
    x = _embed(params, cfg, tokens, ctx)
    if visual_embeds is not None:
        n_vis = visual_embeds.shape[1]
        x = torch.cat([visual_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return ctx.scatter_seq(x), default_positions(cfg, tokens, positions)


def default_positions(cfg: ModelConfig, tokens: torch.Tensor,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``positions``, or ``arange(S)`` per row when None, broadcast to
    (3, B, S) for an M-RoPE config."""
    if positions is not None:
        return positions
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.mrope_sections:
        positions = positions.expand(3, B, S)
    return positions


def rope_of(cfg: ModelConfig, positions: torch.Tensor):
    """The rotary tables every attention layer of a forward shares (None
    for a config without attention layers)."""
    return _rope(cfg, positions) if _has_attention(cfg) else None


def _hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor], return_cache: bool,
            enc_frames: Optional[torch.Tensor] = None,
            visual_embeds: Optional[torch.Tensor] = None,
            ctx: ShardCtx = NULL_CTX, rest: bool = True):
    """The encoder (encoder–decoder models), the embedding and the layer
    stack on cast params → (x, cache, the layers' summed aux loss, the
    rotary tables, the encoder's output); each layer rematerialized
    under autograd (``cfg.remat``).  ``rest=False`` stops before the
    remainder layers (the loss runs them in :func:`head_loss_terms`)."""
    enc_out = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError("encoder-decoder model needs enc_frames")
        enc_out = encode_frames(params, cfg, enc_frames, ctx)
    x, positions = embed_tokens(params, cfg, tokens, positions,
                                visual_embeds, ctx)
    B, S = tokens.shape
    rope = rope_of(cfg, positions)
    n_groups = cfg.n_layers // len(cfg.block_pattern)
    KvDh = local_kv_heads(cfg, ctx.tp) * cfg.head_dim
    cache = None
    if return_cache:
        cache = {"groups": {}, "rest": {}}
        for k, kind in enumerate(cfg.block_pattern):
            cache["groups"][f"p{k}"] = {
                n: torch.empty((n_groups, B, S, KvDh), dtype=x.dtype,
                               device=x.device) for n in ("k", "v")
            } if kind in ATTENTION_KINDS else ()
    auxes: list = []
    items = _layers(params, cfg) if rest else _group_items(
        params["groups"], cfg)
    x = _run_layers(items, x, cfg, rope, enc_out, ctx, auxes, cache)
    return x, cache or {"groups": {}, "rest": {}}, _aux_total(auxes, x), \
        rope, enc_out


def forward(
    params: PyTree,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    positions: Optional[torch.Tensor] = None,  # (B, S) or (3, B, S)
    enc_frames: Optional[torch.Tensor] = None,  # (B, T_enc, d) whisper
    visual_embeds: Optional[torch.Tensor] = None,  # (B, n_vis, d) vlm
    return_cache: bool = False,
    last_only: bool = False,  # unembed only the final position (prefill)
    ctx: Optional[ShardCtx] = None,  # tensor parallelism (dist.sharding)
):
    """Full-sequence forward → ``(logits (B, S, V) f32, aux)``, or
    ``(logits, cache, aux)`` with ``return_cache``, as the reference's;
    aux is the layers' summed MoE load-balancing loss (0 when dense).
    An encoder–decoder model needs ``enc_frames`` (``ValueError``
    without them).

    The cache holds each layer's K/V as ``(…, S, Kv·Dh)``, stacked per
    pattern position like the reference's scan output (under TP this
    rank's KV heads; its logits vocab-parallel for an untied head).
    """
    ctx = ctx or NULL_CTX
    _check_supported(cfg)
    params = cast_params(params, cfg)
    x, cache, aux, _, _ = _hidden(params, cfg, tokens, positions,
                                  return_cache, enc_frames, visual_embeds,
                                  ctx)
    if last_only:
        # the final position lives on the last rank's block under SP
        x = ctx.gather_seq(x)[:, -1:]
        ctx = ctx.no_sp()
    logits = _unembed(params, cfg, x, ctx)
    return (logits, cache, aux) if return_cache else (logits, aux)


# ----------------------------------------------------------------------
# training loss
# ----------------------------------------------------------------------
def _ce_nll(logits: torch.Tensor, targets: torch.Tensor,
            cfg: Optional[ModelConfig] = None,
            ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S).

    Vocab-parallel logits (TP, untied head) are decoded with ONE fused
    psum over "model" (the local exp-sums and this rank's masked target
    logit together), after a ``pmax`` for the shift, which takes no
    gradient: it cancels analytically."""
    V = logits.shape[-1]
    if ctx.active and cfg is not None and V != cfg.vocab:
        m = ctx.pmax(logits.detach().amax(-1))
        s = torch.exp(logits - m[..., None]).sum(-1)
        tloc = targets.long() - ctx.axis_index() * V
        valid = (tloc >= 0) & (tloc < V)
        ll = torch.gather(logits, -1, tloc.clamp(0, V - 1)[..., None])[..., 0]
        ll = torch.where(valid, ll, torch.zeros_like(ll))
        s, ll = ctx.psum(torch.stack([s, ll])).unbind(0)
        return torch.log(s) + m - ll
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - ll


def head_loss_terms(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                    targets: torch.Tensor, weights: Optional[torch.Tensor],
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    enc_out: Optional[torch.Tensor] = None,
                    ctx: ShardCtx = NULL_CTX
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rest layers + unembed + weighted CE on the group stacks' output;
    ``params`` must already be cast (``rope``: :func:`rope_of`'s tables,
    ``enc_out``: the encoder's output).  Returns the un-normalized ``(Σ
    nll·w, Σ w, aux of the rest layers)`` so the caller picks the
    denominator.  The pipelined step runs it on the last stage."""
    auxes: list = []
    x = _run_layers(_rest_items(params, cfg), x, cfg, rope, enc_out, ctx,
                    auxes)
    logits = _unembed(params, cfg, x, ctx)
    nll = _ce_nll(logits, targets, cfg, ctx)
    w = weights if weights is not None else torch.ones_like(nll)
    return (nll * w).sum(), w.sum(), _aux_total(auxes, x)


def loss_and_metrics(params: PyTree, cfg: ModelConfig,
                     batch: Dict[str, torch.Tensor],
                     aux_weight: float = AUX_WEIGHT,
                     ctx: Optional[ShardCtx] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted token cross-entropy → ``(total, metrics)``.

    ``batch["weights"]`` (B, S) carries padding masks AND the HGC coding
    coefficients: the gradient of this loss IS the worker's encoded
    message ``G_ij``.  ``batch["denom"]``, when given, is the fixed
    normalizer that keeps the loss linear in the weights, which exact
    coded aggregation needs; otherwise the weights' sum (at least 1).
    Under TP (``ctx``) the loss comes out equal on every "model" rank.
    """
    ctx = ctx or NULL_CTX
    _check_supported(cfg)
    params = cast_params(params, cfg)
    x, _, aux, rope, enc_out = _hidden(
        params, cfg, batch["tokens"], batch.get("positions"), False,
        batch.get("enc_frames"), batch.get("visual_embeds"), ctx,
        rest=False)
    nll_sum, w_sum, aux_rest = head_loss_terms(
        params, cfg, x, batch["targets"], batch.get("weights"), rope,
        enc_out, ctx)
    aux = aux + aux_rest
    denom = batch.get("denom")
    if denom is None:
        denom = torch.clamp(w_sum, min=1.0)
    loss = nll_sum / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "weight_sum": w_sum}


# ----------------------------------------------------------------------
# decode: cache init, prefill, single step
# ----------------------------------------------------------------------
def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.window > 0:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", tp: int = 1) -> PyTree:
    """Empty decode cache: ring buffers for local layers, in
    ``cfg.dtype`` (the decode kernel reads q and the cache in one dtype);
    the "ssm"/"recurrent" layers' states in float32, as the reference
    makes them whatever the model dtype.  An encoder–decoder model's
    attention entries add the cross cache ``xk``/``xv`` (B, enc_len,
    Kv·Dh), which :func:`fill_cross_cache` fills, and the cache holds
    ``cross_pos``: the int32 device scalar ``enc_len − 1`` that every
    cross decode passes to the decode kernel as its query position (no
    step allocates it or syncs the host).  Under TP (``tp``) the K/V
    width (self and cross) is this rank's heads' (:func:`local_kv_heads`)
    and the recurrent states hold its heads or channels."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = _torch_dtype(cfg.dtype)
    KvDh = local_kv_heads(cfg, tp) * cfg.head_dim
    P = len(cfg.block_pattern)
    n_groups, n_rest = cfg.n_layers // P, cfg.n_layers % P

    def entry(kind, lead=()):
        if kind == "ssm":
            return ssm_lib.ssm_init_cache(cfg, batch, lead, device, tp)
        if kind == "recurrent":
            return rglru_lib.rglru_init_cache(cfg, batch, lead, device, tp)
        shp = lead + (batch, _cache_len(cfg, kind, max_len), KvDh)
        e = {"k": torch.zeros(shp, dtype=dt, device=device),
             "v": torch.zeros(shp, dtype=dt, device=device)}
        if cfg.is_encdec:
            xshp = lead + (batch, cfg.enc_len, KvDh)
            e["xk"] = torch.zeros(xshp, dtype=dt, device=device)
            e["xv"] = torch.zeros(xshp, dtype=dt, device=device)
        return e

    cache = {
        "groups": {f"p{k}": entry(cfg.block_pattern[k], (n_groups,))
                   for k in range(P)},
        "rest": {f"r{k}": entry(cfg.block_pattern[k])
                 for k in range(n_rest)},
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.is_encdec:
        cache["cross_pos"] = torch.tensor(cfg.enc_len - 1,
                                          dtype=torch.int32, device=device)
    return cache


def fill_cross_cache(params: PyTree, cfg: ModelConfig,
                     enc_frames: torch.Tensor, cache: PyTree,
                     ctx: ShardCtx = NULL_CTX) -> PyTree:
    """Run the encoder over ``enc_frames`` (B, enc_len, d) and write every
    decoder layer's cross-attention K/V (``enc_out @ xattn.wk / wv``)
    into the cache, in place; once per request, before the decode
    (whisper).  Under TP (``ctx``) the encoder runs at this rank's heads
    and the cache holds this rank's KV heads (the one head of its Q block
    when K/V are replicated).  → the cache."""
    if enc_frames.shape[1] != cfg.enc_len:
        raise ValueError(f"{enc_frames.shape[1]} encoder frames; the cross "
                         f"cache holds enc_len={cfg.enc_len}")
    params = cast_params(params, cfg)
    enc_out = encode_frames(params, cfg, enc_frames, ctx)
    Dh = cfg.head_dim
    P = len(cfg.block_pattern)
    layers = ([(cache["groups"][f"p{k}"], params["groups"][f"p{k}"])
               for k in range(P)]
              + [(cache["rest"][f"r{k}"], params["rest"][f"r{k}"])
                 for k in range(cfg.n_layers % P)])
    for entry, layer in layers:
        for name, w in (("xk", layer["xattn"]["wk"]),
                        ("xv", layer["xattn"]["wv"])):
            # a stacked (L, d, Kv·Dh) weight projects every layer of the
            # group in one batched matmul: (L, B, T, Kv·Dh)
            kv = enc_out @ w if w.ndim == 2 else enc_out @ w[:, None]
            width = entry[name].shape[-1]
            if kv.shape[-1] != width:  # replicated K/V: this rank's head
                head = ctx.axis_index() * cfg.n_kv_heads // ctx.tp
                kv = kv.narrow(-1, head * Dh, width)
            entry[name].copy_(kv)
    return cache


def _decode_attn(a: Dict, h: torch.Tensor, kind: str, cfg: ModelConfig,
                 cache_entry: Dict, pos: torch.Tensor,
                 rope: Tuple[torch.Tensor, torch.Tensor],
                 ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One token's self-attention against the layer's ring buffers (under
    TP this rank's heads, the out-projection psum'd)."""
    B = h.shape[0]
    Dh = cfg.head_dim
    H, Kv = attn_lib.local_head_counts(a, Dh)
    q = attn_lib.rotate(_split_heads(h @ a["wq"], H, Dh), *rope)
    k = _split_heads(h @ a["wk"], Kv, Dh)
    v = _split_heads(h @ a["wv"], Kv, Dh)
    if _kv_slice(ctx, cfg, H, Kv):
        k, v, Kv = _kv_head(k, ctx, Kv), _kv_head(v, ctx, Kv), 1
    k = attn_lib.rotate(k, *rope)
    kc, vc = cache_entry["k"], cache_entry["v"]
    C = kc.shape[1]
    window = cfg.window if kind == "local" else 0
    # in-place ring write where the reference uses dynamic_update_slice:
    # saves a copy of the layer's cache per step; the slot index stays
    # on the device (no host sync)
    slot = torch.remainder(pos, C).to(torch.int64).reshape(1)
    kc.index_copy_(1, slot, k.reshape(B, 1, Kv * Dh).to(kc.dtype))
    vc.index_copy_(1, slot, v.reshape(B, 1, Kv * Dh).to(vc.dtype))
    out = ops.decode_attention(
        q, kc.view(B, C, Kv, Dh), vc.view(B, C, Kv, Dh), pos,
        window=window, softcap=cfg.logit_softcap)
    out = out.reshape(B, 1, H * Dh) @ a["wo"]
    if ctx.active and H != cfg.n_heads:
        out = ctx.psum(out)
    return out


def _decode_cross(a: Dict, h: torch.Tensor, cfg: ModelConfig,
                  cache_entry: Dict, cross_pos: torch.Tensor,
                  ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One token's cross-attention over the static cross cache, through
    the decode kernel at ``cross_pos = Ce − 1``: the ring formula then
    gives every slot s position s ≤ Ce − 1, so every encoder frame is
    attended — the reference's mask (``q_pos = Ce`` over ``arange(Ce)``).
    No RoPE, no window, no softcap, as the reference's cross decode.
    Under TP this rank's heads against its cross cache, ``wo`` psum'd."""
    B = h.shape[0]
    Dh = cfg.head_dim
    H = a["wq"].shape[-1] // Dh
    xk, xv = cache_entry["xk"], cache_entry["xv"]
    Ce, Kv = xk.shape[1], xk.shape[-1] // Dh
    q = _split_heads(h @ a["wq"], H, Dh)
    out = ops.decode_attention(q, xk.view(B, Ce, Kv, Dh),
                               xv.view(B, Ce, Kv, Dh), cross_pos)
    out = out.reshape(B, 1, H * Dh) @ a["wo"]
    if ctx.active and H != cfg.n_heads:
        out = ctx.psum(out)
    return out


def _decode_layer(p: Dict, x1: torch.Tensor, kind: str, cfg: ModelConfig,
                  cache_entry: Dict, pos: torch.Tensor,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                  cross_pos: Optional[torch.Tensor] = None,
                  ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    h = _norm(p["norm1"], x1)
    if kind in ATTENTION_KINDS:
        out = _decode_attn(p["attn"], h, kind, cfg, cache_entry, pos, rope,
                           ctx)
    else:
        if kind == "ssm":
            out, new = ssm_lib.ssm_decode_step(p["ssm"], h, cache_entry, cfg,
                                               ctx)
        else:
            out, new = rglru_lib.rglru_block_step(p["rglru"], h,
                                                  cache_entry, cfg, ctx)
        for name, t in new.items():  # in place, as the ring writes
            cache_entry[name].copy_(t)
    x1 = x1 + out
    if "xattn" in p and "xk" in cache_entry:
        x1 = x1 + _decode_cross(p["xattn"], _norm(p["norm_x"], x1), cfg,
                                cache_entry, cross_pos, ctx)
    if "norm2" in p:
        # MoE: N = B tokens, so the capacity drops what the reference's
        # decode step drops
        x1 = x1 + _ffn_apply(p, _norm(p["norm2"], x1), cfg, ctx)[0]
    return x1


def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: PyTree, ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step against the cache; returns (logits (B, V), cache).

    The cache is updated in place — each layer's ring slot and then
    ``length`` — and returned; ``length`` stays an int32 tensor on the
    device, which the decode kernel reads as the token's position.  An
    M-RoPE model rotates with all three streams at that position, as
    the reference's decode does.  Under TP (``ctx``) the logits of an
    untied head are vocab-parallel (``ShardCtx.argmax`` decodes them).
    """
    ctx = ctx or NULL_CTX
    _check_supported(cfg)
    pos = cache["length"]
    params = cast_params(params, cfg)
    x = _embed(params, cfg, token, ctx)
    rope = None
    if _has_attention(cfg):
        posb = pos.expand(token.shape[0], 1)
        if cfg.mrope_sections:
            posb = posb.expand(3, *posb.shape)
        rope = _rope(cfg, posb)
    for lp, kind, (part, key), l in _layers(params, cfg):
        entry = cache[part][key]
        x = _decode_layer(lp, x, kind, cfg,
                          entry if l is None else _index(entry, l), pos,
                          rope, cache.get("cross_pos"), ctx)
    logits = _unembed(params, cfg, x, ctx)[:, 0]
    cache["length"].add_(1)
    return logits, cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            visual_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False, ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Full-sequence forward that also materializes the K/V cache
    (full length; :func:`prefill_to_decode_cache` re-lays it) →
    ``(logits, cache)``."""
    logits, cache, _ = forward(params, cfg, tokens, positions, enc_frames,
                               visual_embeds, return_cache=True,
                               last_only=last_only, ctx=ctx)
    return logits, cache


def bulk_prefill_supported(cfg: ModelConfig) -> bool:
    """Whether the bulk prefill → decode-cache handoff covers this arch.

    The full-sequence forward materializes only attention K/V entries;
    the recurrent states (SSD, RG-LRU) exist only on the decode path, so
    those archs hand off token by token (the exact handoff).
    """
    return (set(cfg.block_pattern) <= set(ATTENTION_KINDS)
            and not cfg.is_encdec)


def prefill_to_decode_cache(cfg: ModelConfig, prefill_cache: PyTree,
                            max_len: int) -> PyTree:
    """Re-lay a bulk-prefill cache into ``decode_step``'s layout, in
    ``cfg.dtype``.

    Keeps the last ``min(S, C)`` positions of each layer and scatters
    each to its ring slot ``pos % C`` — the state ``S`` decode steps
    would have built.
    """
    if not bulk_prefill_supported(cfg):
        raise ValueError(
            f"{cfg.name}: bulk prefill handoff needs an attention-only "
            f"decoder (pattern {cfg.block_pattern}); use the exact "
            f"token-by-token handoff")
    dt = _torch_dtype(cfg.dtype)
    k0 = prefill_cache["groups"]["p0"]["k"]  # (n_groups, B, S, Kv·Dh)
    S, device = k0.shape[-2], k0.device

    def convert(entry, kind):
        C = _cache_len(cfg, kind, max_len)
        if kind != "local" and S > C:
            raise ValueError(
                f"prompt length {S} exceeds cache size {C} — raise max_len")
        keep = min(S, C)
        slots = torch.arange(S - keep, S, device=device) % C

        def scatter(x):
            buf = torch.zeros(x.shape[:-2] + (C, x.shape[-1]), dtype=dt,
                              device=device)
            buf[..., slots, :] = x[..., S - keep:, :].to(dt)
            return buf

        return {"k": scatter(entry["k"]), "v": scatter(entry["v"])}

    P = len(cfg.block_pattern)
    cache = {
        "groups": {f"p{k}": convert(prefill_cache["groups"][f"p{k}"],
                                    cfg.block_pattern[k])
                   for k in range(P)},
        "rest": {f"r{k}": convert(prefill_cache["rest"][f"r{k}"],
                                  cfg.block_pattern[k])
                 for k in range(cfg.n_layers % P)},
    }
    cache["length"] = torch.tensor(S, dtype=torch.int32, device=device)
    return cache
