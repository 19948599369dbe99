"""Batched serving driver CLI of the port: prefill + decode with KV caches.

PyTorch counterpart of ``repro.launch.serve`` on one device: random
weights from ``--seed`` (made on the device), a random prompt, the bulk
prefill (flash-attention kernel) handed off into the decode ring buffers,
then ``--gen`` greedy decode steps (decode-attention kernel).  An
encoder–decoder arch (whisper-medium) gets ``(batch, enc_len, d_model)``
normal frames from the seed, encoded into the cross cache (flash
kernel), and hands the prompt off token by token.  Runs on the card
unless ``--device cpu`` is given.

``--tp N`` serves tensor-parallel over N ranks (``dist.sharding``): the
CLI spawns them (``dist.launch.run_ranks``; gloo on the CPU or when the
ranks share one card, NCCL when each has a card of its own), or joins
the world of a launcher that sets ``RANK``/``WORLD_SIZE`` (torchrun).
Each rank draws the tp-1 weights from the seed and keeps its slices;
rank 0 prints and writes ``--tokens-out``.  Every config serves at
``--tp``: the MoE layer expert-parallel, the recurrent archs with each
rank's states over its heads or channels, whisper encoding once a
request at a rank's heads into a per-rank cross cache.  Serving has no
sequence parallelism, as in the reference.

``--smoke/--no-smoke`` picks the smoke or the full config (default
smoke); ``--no-smoke`` serves the full config, e.g. llama3-8b (≈16 GB of
bf16 weights), granite-8b, starcoder2-3b, gemma3-27b (≈54 GB),
granite-moe-3b-a800m, qwen2-vl-2b or whisper-medium; ``--layers N``
keeps its first N layers (llama4-maverick-400b-a17b's 48 are ≈ 800 GB).
:func:`serve` is the same request for a config built by the caller.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --no-smoke --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --no-smoke --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-maverick-400b-a17b --no-smoke --layers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --f32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --f32 \
      --tp 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.api import serving
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.dist.launch import join_launcher_world, run_ranks
from repro_torch.dist.sharding import (
    NULL_CTX,
    ShardCtx,
    model_ctx,
    validate_tp,
)
from repro_torch.models import transformer as tf


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke config (default); --no-smoke serves the "
                         "full config")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the config cut to its first N layers "
                         "(default: all of them)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: the ranks to spawn (or "
                         "the launcher's world to join)")
    ap.add_argument("--exact-handoff", action="store_true",
                    help="debug: feed the prompt through decode_step "
                         "token by token instead of the bulk prefill")
    ap.add_argument("--f32", action="store_true",
                    help="force float32 compute")
    ap.add_argument("--tokens-out", default="",
                    help="write the generated token matrix as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.layers:
        if not 0 < args.layers <= cfg.n_layers:
            ap.error(f"--layers {args.layers}: {args.arch} has "
                     f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    ctx = NULL_CTX
    if args.tp > 1:
        validate_tp(cfg, args.tp)
        if not join_launcher_world(args.device):
            resolve_device(args.device)  # no CUDA: raise here, not in a rank
            return run_ranks(main, args.tp, args=(argv,),
                             device=args.device)[0]
        ctx = model_ctx(args.tp)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen, seed=args.seed, device=args.device,
                exact_handoff=args.exact_handoff, ctx=ctx)
    toks = res["tokens"]
    if args.tokens_out and _rank() == 0:
        with open(args.tokens_out, "w") as f:
            json.dump({"tp": args.tp, "tokens": toks.tolist()}, f)
    return res


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def serve(cfg, *, batch: int, prompt_len: int, gen_len: int, seed: int = 0,
          device="cuda", exact_handoff: bool = False,
          ctx: Optional[ShardCtx] = None) -> dict:
    """One request: random weights and prompt (and, for an encoder–
    decoder model, encoder frames) from ``seed``, prefill, ``gen_len``
    greedy tokens → the tokens, the last logits (on the host, gathered
    over the vocabulary under TP), the host times and the peak memory
    (printed as the CLI prints them, by rank 0 under TP); ``prefill_ms``
    includes the encoder.  Under TP (``ctx``) every rank of the model
    axis calls it: each keeps its slices of the tp-1 weights."""
    device = resolve_device(device)
    ctx = ctx or NULL_CTX
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tf.init_params(cfg, gen, device=device, tp=ctx.tp,
                                rank=ctx.axis_index())
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen, device=device)
        enc_frames = None
        if cfg.is_encdec:
            enc_frames = torch.randn((batch, cfg.enc_len, cfg.d_model),
                                     generator=gen, device=device)
        max_len = prompt_len + gen_len + 1
        prefill = serving.make_prefill_fn(cfg, max_len, exact=exact_handoff,
                                          ctx=ctx)
        decode = serving.make_decode_fn(cfg, ctx=ctx)
        seen = {}

        # obs spans (no-ops unless a torch.profiler is recording):
        # "serve.prefill" ends after the prefill's kernels, "serve.request"
        # after the tokens' host copy, so the device work between the two
        # ends is the decode's; inside the prefill, serving's exact handoff
        # puts an encoder–decoder model's encoder under "serve.encode"
        def timed_prefill(p, tokens, *frames):
            _sync(device)
            with obs.span("serve.prefill"):
                t = time.perf_counter()
                out = prefill(p, tokens, *frames)
                _sync(device)
                seen["prefill_s"] = time.perf_counter() - t
            return out

        def watched_decode(p, tok, cache):
            logits, cache = decode(p, tok, cache)
            seen["last_logits"] = logits
            return logits, cache

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with obs.span("serve.request"):
            t0 = time.perf_counter()
            toks = serving.generate_tokens(
                params, cfg, prompt, gen_len, prefill_fn=timed_prefill,
                decode_fn=watched_decode, enc_frames=enc_frames, seed=seed,
                ctx=ctx)
            total = time.perf_counter() - t0  # ends in the tokens' host copy
        last = seen.get("last_logits")
        if last is not None and last.shape[-1] != cfg.vocab:
            last = ctx.all_gather(last, -1)
    decode_s = total - seen["prefill_s"]
    stats = {
        "prefill_ms": 1e3 * seen["prefill_s"],
        "decode_ms_per_token": 1e3 * decode_s / max(gen_len, 1),
        "tok_per_s": batch * gen_len / decode_s if decode_s else 0.0,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    mode = "exact-handoff" if (exact_handoff
                               or not tf.bulk_prefill_supported(cfg)) \
        else "bulk-prefill"
    if _rank() == 0:
        tp = f", tp {ctx.tp}" if ctx.active else ""
        print(f"[serve] {cfg.name} ({device.type}, {mode}{tp}): generated "
              f"{toks.shape} tokens in {total:.3f}s; prefill "
              f"{stats['prefill_ms']:.2f} ms, decode "
              f"{stats['decode_ms_per_token']:.3f} ms/token "
              f"({stats['tok_per_s']:.1f} tok/s)")
        print("[serve] sample:", toks[0][:16].tolist())
    return {"tokens": toks,
            "last_logits": None if last is None else last.cpu(), **stats}


if __name__ == "__main__":
    main()
