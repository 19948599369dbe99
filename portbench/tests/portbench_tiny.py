"""Tiny cells of the benchmark for the CPU tests: the real cells' traffic
mixes and limits at a few layers, narrow widths and short sequences.

The tiny models compute in float32: the limits were read at the cells'
widths in bfloat16, and bfloat16's rounding weighs more in a 64-wide
model, so a sound tiny run is a float32 one; the faults and the fp8
control must still fail the cells' limits from there."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]

DENSE = {"name": "granite-8b-tiny", "family": "dense", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab": 256, "rope_theta": 10000.0,
         "tie_embeddings": False, "dtype": "float32",
         "param_dtype": "float32", "attn_chunk": 32}
MOE = dict(DENSE, name="granite-moe-tiny", family="moe", d_ff=32,
           n_experts=8, top_k=2, capacity_factor=1.25, tie_embeddings=True)
#: serving reads logit gaps: wide enough that a random token's logit
#: lies well below the best (their spread grows with √d)
SERVED = dict(DENSE, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
              d_ff=256, vocab=8192)

SHRINK = {"granite8b.train_s512": (DENSE, dict(seq_len=16)),
          "granitemoe.train_s1024": (MOE, dict(seq_len=16, part_batch=2)),
          "granite8b.serve_code": (SERVED, dict(
              batch=4, gen=16, cycle=[8, 16, 8, 24], sample=8,
              profile_length=8))}


def cell(name: str, **model) -> spec.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` at its tiny size."""
    real = spec.load(ROOT, name)
    m, tr = SHRINK[name]
    return dataclasses.replace(
        real, config={"model": dict(m, **model)},
        traffic=dict(real.traffic, **tr))


def run(c: spec.Cell, seed: int = 2**31 + 17, seconds: float = 0.3):
    """The cell's driver on the CPU, as ``run.py`` calls it."""
    return spec.driver(c).run(c, seed, seconds, False, torch.device("cpu"),
                              lambda: None, time.time())


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
