"""Serving building blocks of the port: prefill → decode handoff + sampling.

PyTorch counterpart of ``repro.api.serving``.  Two prefill paths, both
ending in ``decode_step``'s cache layout:

  * **bulk** (default): one ``tf.prefill`` forward over the whole prompt
    (flash-attention kernel), re-laid into the decode ring buffers by
    ``tf.prefill_to_decode_cache``,
  * **exact** (``exact=True``, and the only path for archs whose
    recurrent or cross-attention states exist only on the decode path):
    the prompt fed through ``decode_step`` one token at a time (decode-
    attention kernel) — an encoder–decoder model's cross cache filled
    first by ``tf.fill_cross_cache`` (the encoder on the flash kernel).

Everything runs eagerly under ``torch.inference_mode()``; the token loop
keeps tokens on the device and copies them to the host once, at the end.

Under tensor parallelism every rank runs the same loop on its slices
with a :class:`~repro_torch.dist.sharding.ShardCtx` (``ctx``): its
decode cache holds its KV heads (its cross cache and its recurrent
states too), and the greedy token of vocab-parallel
logits is the global argmax (``ShardCtx.argmax``), so every rank feeds
the same token.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import NULL_CTX, ShardCtx
from repro_torch.models import transformer as tf


def make_prefill_fn(cfg: ModelConfig, max_len: int, *,
                    exact: bool = False,
                    ctx: Optional[ShardCtx] = None) -> Callable:
    """→ ``prefill(params, tokens[, enc_frames]) → (last_logits (B, V),
    cache)``; ``enc_frames`` (B, T_enc, d) for an encoder–decoder model.

    The cache is kept in ``cfg.dtype``: the decode kernel reads q and the
    cache in one dtype.  (The reference's ``dtype`` option, an f32 cache
    upcast in its attention, has no counterpart here.)
    """
    use_bulk = tf.bulk_prefill_supported(cfg) and not exact
    ctx = ctx or NULL_CTX

    def bulk(params, tokens, enc_frames=None):
        with obs.span("serving.prefill"):
            logits, pcache = tf.prefill(params, cfg, tokens, last_only=True,
                                        ctx=ctx)
        with obs.span("serving.handoff"):
            cache = tf.prefill_to_decode_cache(cfg, pcache, max_len)
        return logits[:, -1], cache

    def exact_loop(params, tokens, enc_frames=None):
        B, S = tokens.shape
        cache = tf.init_cache(cfg, B, max_len, device=tokens.device,
                              tp=ctx.tp)
        if cfg.is_encdec:
            # an obs.span (a no-op unless a profiler records): the serve
            # CLI's phase report splits the encoder from the handoff
            with obs.span("serve.encode"):
                cache = tf.fill_cross_cache(params, cfg, enc_frames, cache,
                                            ctx)
        logits = None
        for t in range(S):
            logits, cache = tf.decode_step(params, cfg, tokens[:, t:t + 1],
                                           cache, ctx)
        return logits, cache

    return bulk if use_bulk else exact_loop


def make_decode_fn(cfg: ModelConfig,
                   ctx: Optional[ShardCtx] = None) -> Callable:
    """→ ``decode(params, token, cache) → (logits, cache)``.

    The decode-attention kernel is chosen by the device of the tensors
    (``kernels.ops``), so there is no switch to resolve here.
    """
    def decode(params, token, cache):
        return tf.decode_step(params, cfg, token, cache, ctx)

    return decode


def generate_tokens(params, cfg: ModelConfig, prompt: torch.Tensor,
                    gen_len: int, **kw) -> np.ndarray:
    """:func:`token_loop`'s tokens on the host (numpy)."""
    return token_loop(params, cfg, prompt, gen_len, **kw).cpu().numpy()


def token_loop(params, cfg: ModelConfig, prompt: torch.Tensor,
               gen_len: int, *, prefill_fn: Callable, decode_fn: Callable,
               enc_frames=None, greedy: bool = True, seed: int = 0,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The generation loop over prebuilt step fns → (B, gen_len) int32
    tokens on the prompt's device (on ``meta``, the dry run's shapes).

    ``enc_frames`` go to the prefill of an encoder–decoder model.
    Greedy takes the first maximum, as ``jnp.argmax`` does (under TP
    over the whole vocabulary: ``ctx.argmax``); sampling draws from
    ``softmax(logits)`` (vocab-parallel logits gathered first) with a
    ``torch.Generator`` seeded by ``seed`` on the prompt's device, the
    same draw on every rank.
    """
    ctx = ctx or NULL_CTX

    def pick(logits):
        if greedy:
            return ctx.argmax(logits, cfg.vocab)[:, None].to(torch.int32)
        if logits.shape[-1] != cfg.vocab:
            logits = ctx.all_gather(logits, -1)
        probs = torch.softmax(logits.float(), -1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

    if cfg.is_encdec:
        logits, cache = prefill_fn(params, prompt, enc_frames)
    else:
        logits, cache = prefill_fn(params, prompt)
    gen = None
    if not greedy:
        gen = torch.Generator(device=prompt.device).manual_seed(seed)
    out = []
    tok = ctx.argmax(logits, cfg.vocab)[:, None].to(torch.int32)
    for _ in range(gen_len):
        out.append(tok)
        with obs.span("serving.decode"):
            logits, cache = decode_fn(params, tok, cache)
            tok = pick(logits)
    return torch.cat(out, dim=1)


def _on_device(params, device: torch.device) -> None:
    leaf = params["embed"]["table"]
    if leaf.device.type != device.type:
        raise ValueError(f"params live on {leaf.device}, not on {device}")


def frames_on(enc_frames, device: torch.device):
    """``enc_frames`` (numpy or a tensor) as a float tensor on ``device``;
    None stays None."""
    if enc_frames is None:
        return None
    if not isinstance(enc_frames, torch.Tensor):
        enc_frames = torch.from_numpy(np.asarray(enc_frames, np.float32))
    return enc_frames.to(device)


@torch.inference_mode()
def prefill_into_cache(params, cfg: ModelConfig, tokens, max_len: int,
                       enc_frames=None, *, exact: bool = False,
                       device="cuda") -> Tuple[torch.Tensor, object]:
    """Single-host convenience: run one prefill → (logits, cache)."""
    device = resolve_device(device)
    _on_device(params, device)
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=device)
    fn = make_prefill_fn(cfg, max_len, exact=exact)
    if cfg.is_encdec:
        return fn(params, tokens, frames_on(enc_frames, device))
    return fn(params, tokens)


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompt, gen_len: int,
             max_len: Optional[int] = None, enc_frames=None,
             greedy: bool = True, seed: int = 0,
             exact_handoff: bool = False, device="cuda",
             ctx: Optional[ShardCtx] = None) -> np.ndarray:
    """Generation → (B, gen_len) int32 tokens (numpy).

    Runs on ``device`` (the card unless the caller asks for the CPU);
    ``params`` must already live there.  An encoder–decoder model takes
    its ``enc_frames`` (B, T_enc, d).  Under TP (``ctx``) every rank
    calls it with its slices and gets the same tokens.
    """
    device = resolve_device(device)
    _on_device(params, device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    max_len = max_len or prompt.shape[1] + gen_len + 1
    return generate_tokens(
        params, cfg, prompt, gen_len,
        prefill_fn=make_prefill_fn(cfg, max_len, exact=exact_handoff,
                                   ctx=ctx),
        decode_fn=make_decode_fn(cfg, ctx=ctx),
        enc_frames=frames_on(enc_frames, device), greedy=greedy,
        seed=seed, ctx=ctx,
    )
