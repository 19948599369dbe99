#!/usr/bin/env python3
"""The PyTorch/CUDA port on one NVIDIA card: build, check, serve.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  0. device: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 off for matmuls and convolutions.
  1. build: every kernel of the port from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, in parallel).
  2. kernels against their plain versions on the card, over a grid of
     shapes (tolerance 1e-4 in float32, 2e-2 in bfloat16), then checked
     and timed at the serving path's shapes: besides the grid's
     tolerance, every output row (the Dh features of one query and head)
     must be within a share of its own max |plain| (decode 1e-2, flash
     2e-2: one bf16 rounding is at most 2^-7 of it); timed beside the
     plain version, the least time the card could take (bound) and one
     PyTorch library call (``scaled_dot_product_attention``, timed only
     as a yardstick).
  3. full-width parity: llama3-8b at full width cut to 2 layers, float32,
     seeded weights on the card and on the CPU; bulk prefill of 2 × 64
     tokens then 8 greedy decode steps on the card, the CPU run
     teacher-forced on the card's tokens; logits agree within
     2e-3 · max|logit|.
  4. the main path: ``repro_torch.launch.serve.main`` serves the full
     llama3-8b (32 layers, bf16, random weights from the seed) to
     4 × 1024-token prompts for 32 tokens, once to warm up and once
     counted; the kernels' launch counts over the counted run must be
     exactly 32 (flash) and 1024 (decode).  A third request runs under
     ``torch.profiler``: its device time in the prefill and in the decode
     (split by the serve CLI's profiler spans), over the counted run's
     host times, is the share of each phase the device was busy.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the serving path's shapes: llama3-8b, batch 4, 1024-token prompts, 32 new
B, PROMPT, GEN = 4, 1024, 32
H, KV, DH = 32, 8, 128
CACHE = PROMPT + GEN + 1  # max_len of the serve CLI


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def check_rows(got, want, share: float, what: str) -> float:
    """Every output row (last axis) within ``share`` of its own max
    |want|; → the worst row's error as a share of that max."""
    worst = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    if not worst <= share:
        raise AssertionError(f"{what}: a row is off by {worst:.3g} of its "
                             f"max |plain|, limit {share}")
    return worst


# ----------------------------------------------------------------------
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = build.build_all()
    log(f"[build] {len(build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s -> {out.relative_to(ROOT)}")
    for name in build.sources():  # what -Xptxas -v reported per kernel
        text = (out / f"{name}.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"[build] {name}: {len(regs)} kernels, registers "
            f"{min(regs)}..{max(regs)}, {sum(s > 0 for s in spills)} "
            f"with spills")
    for name in build.sources():
        build.load(name)


def _grid_decode(torch, dtype, gen):
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    worst = 0.0
    grid = itertools.product(["empty", "partial", "full", "wrapped"],
                             [0, 8], [0.0, 30.0], [1, 2, 8], [1, 8],
                             [16, 32, 64, 128, 256], [4, 40, 1057])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 0
    for pos_kind, window, softcap, G, Kv, Dh, C in grid:
        pos = {"empty": 0, "partial": max(C // 2 - 1, 0), "full": C - 1,
               "wrapped": 2 * C + 3}[pos_kind]
        q = torch.randn(2, 1, Kv * G, Dh, generator=gen, device="cuda")
        k = torch.randn(2, C, Kv, Dh, generator=gen, device="cuda")
        v = torch.randn(2, C, Kv, Dh, generator=gen, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = decode_attention_fwd(q, k, v, pos, window=window,
                                   softcap=softcap).float()
        want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                        softcap=softcap).float()
        torch.testing.assert_close(
            got, want, rtol=tol, atol=tol,
            msg=lambda m: f"decode {pos_kind} w={window} cap={softcap} "
                          f"G={G} Kv={Kv} Dh={Dh} C={C} {dtype}: {m}")
        worst = max(worst, (got - want).abs().max().item())
        n += 1
    return n, worst


def _grid_flash(torch, dtype, gen):
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    worst = 0.0
    head_dims = [16, 32, 64, 128] + ([256] if dtype == torch.float32 else [])
    grid = itertools.product([1, 17, 64, 1000, 1024], [True, False], [0, 16],
                             [0.0, 30.0], [1, 4], head_dims)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 0
    for S, causal, window, softcap, G, Dh in grid:
        q = torch.randn(1, S, 2 * G, Dh, generator=gen, device="cuda")
        k = torch.randn(1, S, 2, Dh, generator=gen, device="cuda")
        v = torch.randn(1, S, 2, Dh, generator=gen, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap).float()
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window,
                                       softcap=softcap).float()
        torch.testing.assert_close(
            got, want, rtol=tol, atol=tol,
            msg=lambda m: f"flash S={S} causal={causal} w={window} "
                          f"cap={softcap} G={G} Dh={Dh} {dtype}: {m}")
        worst = max(worst, (got - want).abs().max().item())
        n += 1
    return n, worst


def _time_decode(torch):
    """Decode attention at the serve path's shapes (bf16, mid-generation
    q_pos).  Several cache copies rotate so that, as in the model where
    32 layers' caches pass between two reads of one, no launch finds its
    cache in the 50 MB L2."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    q_pos = PROMPT + GEN // 2
    n_sets = 6
    qs = [torch.randn(B, 1, H, DH, generator=gen, device="cuda").to(dt)
          for _ in range(n_sets)]
    ks = [torch.randn(B, CACHE, KV * DH, generator=gen,
                      device="cuda").to(dt).view(B, CACHE, KV, DH)
          for _ in range(n_sets)]
    vs = [torch.randn(B, CACHE, KV * DH, generator=gen,
                      device="cuda").to(dt).view(B, CACHE, KV, DH)
          for _ in range(n_sets)]
    qp = torch.tensor(q_pos, dtype=torch.int32, device="cuda")
    got = decode_attention_fwd(qs[0], ks[0], vs[0], qp).float()
    want = ref.decode_attention_ref(qs[0], ks[0], vs[0], qp).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    err = (got - want).abs().max().item()
    row_err = check_rows(got, want, 1e-2, "decode at the serve shapes")

    # SDPA yardstick: same function, the ring mask as a boolean mask
    slots = torch.arange(CACHE, device="cuda")
    k_pos = slots + CACHE * torch.div(q_pos - slots, CACHE,
                                      rounding_mode="floor")
    mask = ((k_pos >= 0) & (k_pos <= q_pos))[None, None, None]

    def lib(i):
        return F.scaled_dot_product_attention(
            qs[i].transpose(1, 2), ks[i].transpose(1, 2),
            vs[i].transpose(1, 2), attn_mask=mask, enable_gqa=True)

    torch.testing.assert_close(lib(0).transpose(1, 2).float(), want,
                               rtol=2e-2, atol=2e-2)
    it = iter(range(10 ** 9))

    def rot(f):
        return lambda: f(next(it) % n_sets)

    kernel_ms = timed_ms(rot(lambda i: decode_attention_fwd(
        qs[i], ks[i], vs[i], qp)), 300)
    plain_ms = timed_ms(rot(lambda i: ref.decode_attention_ref(
        qs[i], ks[i], vs[i], qp)), 100)
    lib_ms = timed_ms(rot(lib), 300)
    n_valid = int(mask.sum())
    nbytes = (2 * B * n_valid * KV * DH + 2 * B * H * DH) * 2 + 4
    flops = 4 * B * H * n_valid * DH
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), row_err


def _time_flash(torch):
    """Flash forward at the prefill's shapes (bf16, causal); q/k/v/o are
    84 MB, more than the L2 holds."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(B, PROMPT, H, DH, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, PROMPT, KV, DH, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, PROMPT, KV, DH, generator=gen, device="cuda").to(dt)
    got = flash_attention_fwd(q, k, v).float()
    want = ref.flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    err = (got - want).abs().max().item()
    row_err = check_rows(got, want, 2e-2, "flash at the serve shapes")

    def lib():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    torch.testing.assert_close(lib().transpose(1, 2).float(), want,
                               rtol=2e-2, atol=2e-2)
    kernel_ms = timed_ms(lambda: flash_attention_fwd(q, k, v), 20)
    plain_ms = timed_ms(lambda: ref.flash_attention_ref(q, k, v), 5)
    lib_ms = timed_ms(lib, 20)
    nbytes = (2 * B * PROMPT * H * DH + 2 * B * PROMPT * KV * DH) * 2
    flops = 4 * B * H * DH * (PROMPT * PROMPT + PROMPT) / 2
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), row_err


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        n, worst = _grid_decode(torch, dtype, gen)
        log(f"[kernels] decode_attention == plain on {n} cases, {dtype}, "
            f"max abs err {worst:.3g} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        n, worst = _grid_flash(torch, dtype, gen)
        log(f"[kernels] flash_attention == plain on {n} cases, {dtype}, "
            f"max abs err {worst:.3g} ({time.perf_counter() - t0:.1f} s)")
    rows = {}
    for name, timer in (("decode_attention", _time_decode),
                        ("flash_attention", _time_flash)):
        r, row_err = timer(torch)
        rows[name] = r
        log(f"[kernels] {name} at the serve shapes: max abs err "
            f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
            f"{r['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return rows


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_parity(seed: int = 0):
    import torch

    from repro_torch.api import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    cpu = tf.init_params(cfg, gen, device="cpu")
    gpu = _to(cpu, "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    max_len = 64 + 8 + 1
    worst = 0.0

    def check(lg, lc, what):
        nonlocal worst
        lg = lg.cpu()
        scale = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= 2e-3 * scale:
            raise AssertionError(f"{what}: max |card - cpu| {err:.3g} > "
                                 f"2e-3 * {scale:.3g}")

    with torch.inference_mode():
        prefill = serving.make_prefill_fn(cfg, max_len)
        decode = serving.make_decode_fn(cfg)
        lg, cg = prefill(gpu, prompt.cuda())
        lc, cc = prefill(cpu, prompt)
        check(lg, lc, "prefill")
        for step in range(8):
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            lg, cg = decode(gpu, tok, cg)
            lc, cc = decode(cpu, tok.cpu(), cc)  # teacher-forced
            check(lg, lc, f"decode step {step}")
    log(f"[parity] llama3-8b full width, 2 layers, f32: card == cpu over "
        f"prefill + 8 decode steps, max err {worst:.3g} x max|logit| "
        f"({time.perf_counter() - t0:.1f} s)")
    del cpu, gpu, cg, cc
    torch.cuda.empty_cache()


def device_ms_by_phase(prof):
    """Device time of one profiled serve request, by phase and name.

    The serve CLI's spans bound the phases on the host clock: the
    device is idle when "serve.prefill" starts and done when it ends, and
    done again when "serve.request" ends, so a kernel belongs to the
    phase in which it started."""
    import collections

    from torch.autograd import DeviceType

    events = prof.events()
    span = {e.name: e.time_range for e in events
            if e.device_type == DeviceType.CPU
            and e.name in ("serve.prefill", "serve.request")}
    if len(span) != 2:
        raise AssertionError(f"profiler spans missing: found {sorted(span)}")
    phases = {"prefill": (span["serve.prefill"].start,
                          span["serve.prefill"].end),
              "decode": (span["serve.prefill"].end,
                         span["serve.request"].end)}
    out = {ph: collections.Counter() for ph in phases}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for ph, (lo, hi) in phases.items():
            if lo <= e.time_range.start < hi:
                out[ph][e.name] += e.time_range.elapsed_us() / 1e3
    if not all(out.values()):
        raise AssertionError("the profiler saw no device work in a phase")
    return out


def phase_serve():
    """The serve CLI at full size, three times: the first request pays
    the one-time costs (cuBLAS heuristics, library loads), the second is
    the counted run — launch counts set to 0 just before it, read just
    after — and the third runs under ``torch.profiler`` for the device
    time of each phase, set against the counted run's host times (the
    profiler slows the host)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--no-smoke", "--batch", str(B),
            "--prompt-len", str(PROMPT), "--gen", str(GEN)]
    cold = serve.main(argv)
    log(f"[serve] first request: prefill {cold['prefill_ms']:.2f} ms, "
        f"decode {cold['decode_ms_per_token']:.3f} ms/token")
    del cold
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = serve.main(argv)
    counts = ops.launch_counts()
    n_layers = 32
    want = {"flash_attention": n_layers, "decode_attention": n_layers * GEN}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    toks = res["tokens"]
    vocab = 128256
    if toks.shape != (B, GEN) or not ((toks >= 0) & (toks < vocab)).all():
        raise AssertionError(f"bad tokens {toks.shape}")
    logits = res["last_logits"]
    if tuple(logits.shape) != (B, vocab) or not torch.isfinite(logits).all():
        raise AssertionError("last logits not finite / wrong shape")
    log(f"[serve] launches {counts}; prefill {res['prefill_ms']:.2f} ms, "
        f"decode {res['decode_ms_per_token']:.3f} ms/token, "
        f"{res['tok_per_s']:.1f} tok/s, max memory allocated "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB; "
        f"tokens[0][:8] {np.asarray(toks[0][:8]).tolist()}")
    del logits
    torch.cuda.empty_cache()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = serve.main(argv)
    by_phase = device_ms_by_phase(prof)
    host = {"prefill": (res["prefill_ms"], profiled["prefill_ms"], 1),
            "decode": (res["decode_ms_per_token"],
                       profiled["decode_ms_per_token"], GEN)}
    for ph, (host_ms, prof_ms, per) in host.items():
        unit = "ms" if per == 1 else "ms/token"
        dev_ms = sum(by_phase[ph].values()) / per
        log(f"[profile] {ph}: device {dev_ms:.3f} {unit} over the counted "
            f"run's host {host_ms:.3f} {unit}: device busy "
            f"{100 * dev_ms / host_ms:.1f}% (host under the profiler "
            f"{prof_ms:.3f} {unit})")
        for name, ms in by_phase[ph].most_common(8):
            log(f"[profile]   {ms / per:9.3f} {unit}  {name[:90]}")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    counts = phase_serve()
    sources = {"decode_attention": ("src/repro_torch/kernels/csrc/"
                                    "decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:131"),
               "flash_attention": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:100")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=counts[name], **r)
               for name, r in rows.items()]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
