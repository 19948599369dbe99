#!/usr/bin/env python3
"""Time the f32 coded combine's design variants on one CUDA card.

Builds ``tools/combine_variants.cu`` (which includes the port's
``csrc/coded_combine.cu``) with the port's nvcc flags, checks every
variant against the plain version (every output row within 1e-5 of its
max |plain|) at the shapes below and at the shipped kernel's edges, then
times each at

  * the evaluation's decode: R = 1, K = 40, F = 845,738 (the CNN), rows
    16 bytes apart (padded, as the simulator lays them out) and packed
    (every odd row 8 bytes off), by CUDA-graph replay beside
    ``torch.mm`` (TF32 off);
  * the training path's HGC encode (R = 8) and decode (R = 1) of K = 8
    per-part gradients of llama3-8b's ``mlp.wd`` leaf (F = 117,440,512),
    by CUDA events beside ``torch.mm``;

in turns (variants 0, 1, ..., then ..., 1, 0), and prints each time with its
share of the bound (bytes at 3.35 TB/s).  Run from the root of a
checkout:

    python3 tools/torch_combine_variants.py

The variants are described at the top of ``tools/combine_variants.cu``.
With ``--scaling``, each variant and ``torch.mm`` are also timed at R = 1,
K = 40 and F = 1, 2, 4 and 8 times the CNN's (padded rows, graph
replay), and a least-squares line through the times splits each into a
fixed cost (the intercept) and a rate (the slope's bytes per second).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {0: "grid-stride (the previous kind 0)",
            1: "registers, contiguous spans, K unrolled by 8",
            2: "registers, interleaved, K unrolled by 4 (shipped)",
            3: "registers, interleaved, K unrolled by 2",
            4: "registers, interleaved, K unrolled by 5",
            5: "registers, interleaved, K unrolled by 8",
            6: "registers, interleaved, K unrolled by 16",
            7: "TMA ring, interleaved tiles",
            8: "TMA ring, contiguous spans",
            9: "TMA ring, 1024 columns x 10 rows a stage",
            10: "TMA ring, 1024 columns x 5 rows a stage",
            11: "TMA ring, two blocks an SM, 256 columns x 20 rows"}


def _load(tmp: Path):
    from repro_torch.kernels import build

    lib = tmp / "libcombine_variants.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(lib), str(ROOT / "tools" / "combine_variants.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib)).combine_variant_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, I, I, P, L, L, P, I, P]
    fn.restype = ctypes.c_int
    return fn


def _scaling(torch, cs, call, inputs):
    import numpy as np

    sizes = [m * cs.CNN_F for m in (1, 2, 4, 8)]
    times = {v: [] for v in list(VARIANTS) + ["torch.mm"]}
    for F in sizes:
        c, g = inputs(1, cs.EVAL_K, F, True)
        for v in VARIANTS:
            times[v].append(cs.graph_ms(lambda: call(v, c, g), n=20))
        times["torch.mm"].append(cs.graph_ms(lambda: torch.mm(c, g), n=20))
        del c, g
        torch.cuda.empty_cache()
    nbytes = np.array([4.0 * (cs.EVAL_K + 1) * F for F in sizes])
    for v, ts in times.items():
        slope, icpt = np.polyfit(nbytes, np.array(ts), 1)
        print(f"[scaling] {v}: " + ", ".join(f"{t:.4f}" for t in ts)
              + f" ms at F x 1, 2, 4, 8: fixed {1e3 * icpt:.2f} us, rate "
              f"{1e-9 / slope:.3f} TB/s", flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="combine_variants."))
    launch = _load(tmp)

    def call(v, c, g):
        R, K = c.shape
        out = torch.empty(R, g.shape[1], device="cuda")
        vec_ok = int(g.data_ptr() % 16 == 0 and g.stride(0) % 4 == 0)
        err = launch(v, c.data_ptr(), R, K, g.data_ptr(), g.stride(0),
                     g.shape[1], out.data_ptr(), vec_ok,
                     torch.cuda.current_stream().cuda_stream)
        build.check(err, f"variant {v}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(5)

    def inputs(R, K, F, padded):
        c = torch.randn(R, K, generator=gen, device="cuda")
        g = torch.randn(K, -(-F // 4) * 4 if padded else F, generator=gen,
                        device="cuda")[:, :F]
        return c, g

    # correctness: the edges of the shipped kernel, then the timed shapes
    edges = [(1, 1, 1, False), (1, 40, 3, False), (1, 40, 64, False),
             (13, 64, 4161, False), (8, 40, 1001, True), (1, 200, 5000, False),
             (13, 200, 70001, False), (1, 8, 2 ** 20 + 3, False)]
    worst = 0.0
    for R, K, F, padded in edges:
        c, g = inputs(R, K, F, padded)
        want = ref.coded_combine_ref(c, g)
        for v in VARIANTS:
            share = cs._row_share(call(v, c, g), want)
            if not share <= 1e-5:
                raise AssertionError(f"variant {v} R={R} K={K} F={F} "
                                     f"padded={padded}: {share:.3g}")
            worst = max(worst, share)
    print(f"[variants] all {len(VARIANTS)} == plain on {len(edges)} edge "
          f"shapes, worst row {worst:.3g} of its max |plain|", flush=True)

    shapes = [("eval padded", 1, cs.EVAL_K, cs.CNN_F, True, "graph"),
              ("eval packed", 1, cs.EVAL_K, cs.CNN_F, False, "graph"),
              ("train encode", 8, 8, cs.WD_F, False, "events"),
              ("train decode", 1, 8, cs.WD_F, False, "events")]
    for name, R, K, F, padded, how in shapes:
        c, g = inputs(R, K, F, padded)
        want = ref.coded_combine_ref(c, g)
        for v in VARIANTS:
            share = cs._row_share(call(v, c, g), want)
            if not share <= 1e-5:
                raise AssertionError(f"variant {v} at {name}: {share:.3g}")
        del want
        bms, _ = cs.bound_ms(4 * (K * F + R * K + R * F), 2 * R * K * F,
                             "float32")

        def timed(fn):
            if how == "graph":
                return cs.graph_ms(fn)
            return cs.timed_ms(fn, 10, warmup=2)

        times = {v: [] for v in VARIANTS}
        for v in list(VARIANTS) + list(reversed(VARIANTS)):
            times[v].append(timed(lambda: call(v, c, g)))
        mm = timed(lambda: torch.mm(c, g))
        line = ", ".join(
            f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms "
            f"({100 * bms / min(ts):.1f}%)" for v, ts in times.items())
        print(f"[variants] {name} R={R} K={K} F={F} ({how}): {line}; "
              f"torch.mm {mm:.4f} ms ({100 * bms / mm:.1f}%); bound "
              f"{bms:.4f} ms", flush=True)
        del c, g
        torch.cuda.empty_cache()
    if "--scaling" in sys.argv:
        _scaling(torch, cs, call, inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
