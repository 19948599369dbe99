"""Serving: a closed loop of static batches through ``serving.generate``.

Set-up draws the run's weights on the card in the served layout and
serves one short batch at every prompt length of the mix (the window's
shapes: the same cache sizes, the same prefill).  The window then
serves batches of the mix's cycle of lengths, each a fresh batch of
prompts from the seed with greedy tokens, until ``--seconds`` have
passed, and closes when the last batch is back on the host.  A traced
run then times the prefill and the decode loop apart on one batch of
each length (synchronized at both ends) and profiles one batch.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, data, profiling, spec, weights, work
from portbench.reference import serve as ref_serve

#: batch indices of the prompts served outside the window
WARM, SPLIT, PROFILED = 10**9, 10**9 + 100, 10**9 + 200


def _split_timing(params, cfg, prompt, gen: int, sync) -> Dict[str, float]:
    """Host seconds of the prefill and of the decode loop of one batch."""
    from repro_torch.api import serving

    prefill = serving.make_prefill_fn(cfg, prompt.shape[1] + gen + 1)
    t: Dict[str, float] = {}

    def timed(p, tokens):
        sync()
        t0 = time.perf_counter()
        out = prefill(p, tokens)
        sync()
        t["prefill_s"] = time.perf_counter() - t0
        t["decode_t0"] = time.perf_counter()
        return out

    with torch.inference_mode():
        serving.token_loop(params, cfg, prompt, gen, prefill_fn=timed,
                           decode_fn=serving.make_decode_fn(cfg)).cpu()
    t["decode_s"] = time.perf_counter() - t.pop("decode_t0")
    return t


class Server:
    """The run's weights in the served layout and the call that serves
    one batch of prompts from the seed through ``serving.generate``."""

    def __init__(self, cell, seed: int, device):
        self.m, self.tr, self.seed, self.device = (cell.model, cell.traffic,
                                                   seed, device)
        self.cfg = spec.model_config(self.m)
        self.params = weights.nest(ref_serve.served_weights(self.m, seed,
                                                            device))

    def prompts(self, index: int, length: int) -> np.ndarray:
        return data.prompt_tokens(self.seed, index, self.tr["batch"], length,
                                  self.m["vocab"])

    def serve(self, index: int, length: int, gen: int = 0) -> np.ndarray:
        from repro_torch.api import serving

        G = self.tr["gen"]
        return serving.generate(self.params, self.cfg,
                                self.prompts(index, length), gen or G,
                                max_len=length + G + 1, device=self.device)

    def warm(self) -> None:
        """One short batch at each length of the mix: the window's shapes
        (the same cache sizes, the same prefill)."""
        for i, length in enumerate(sorted(set(self.tr["cycle"]))):
            self.serve(WARM + i, length, gen=2)

    def window(self, seconds: float, batches: int = 0) -> List[Dict]:
        """Batches of the cycle until ``seconds`` have passed (or exactly
        ``batches`` of them) → one record a batch."""
        cycle, done = self.tr["cycle"], []
        t0 = time.perf_counter()
        while (len(done) < batches if batches
               else time.perf_counter() - t0 < seconds):
            b = len(done)
            length = cycle[b % len(cycle)]
            done.append({"index": b, "length": length,
                         "tokens": self.serve(b, length)})
        return done


def reference_gaps(cell, seed: int, done: List[Dict], device,
                   control: bool = False) -> List[float]:
    """The sampled requests' widest gaps in the reference (with
    ``control``: of the fp8 reference's first choices)."""
    tr, m = cell.traffic, cell.model
    B, V = tr["batch"], m["vocab"]
    W = ref_serve.served_weights(m, seed, device)
    return ref_serve.gaps(W, m, [
        (data.prompt_tokens(seed, d["index"], B, d["length"], V)[r],
         d["tokens"][r]) for d, r in sample(done, seed, tr["sample"], B)],
        device, control)


def run(cell, seed: int, seconds: float, traced: bool, device,
        sync, t_start: float) -> Dict:
    m, tr = cell.model, cell.traffic
    B, G = tr["batch"], tr["gen"]
    srv = Server(cell, seed, device)
    srv.warm()
    sync()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    done = srv.window(seconds)
    window_s = time.perf_counter() - t0
    failed = sum(1 for d in done if d["tokens"].shape != (B, G)) * B
    flops = sum(work.prefill_flops(m, B, d["length"])
                + work.decode_flops(m, B, range(d["length"],
                                                d["length"] + G))
                for d in done)
    rec: Dict = {"setup_s": setup_s, "window_s": window_s,
                 "batches": len(done), "tokens": len(done) * B * G,
                 "flops": flops, "model": m, "traffic": tr}
    if traced:
        split = {}
        for i, length in enumerate(sorted(set(tr["cycle"]))):
            prompt = torch.from_numpy(srv.prompts(SPLIT + i, length)).to(
                device)
            split[length] = _split_timing(srv.params, srv.cfg, prompt, G,
                                          sync)
        rec["split"] = split
        length = tr["profile_length"]
        rec["trace"] = profiling.profile(
            lambda: srv.serve(PROFILED, length), tr["profile_batches"], sync)
        rec["trace"]["length"] = length
    t_ref = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    srv = None  # the program's copy goes before the reference runs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    got = reference_gaps(cell, seed, done, device)
    return {"records": rec, "checks": check.serving(max(got), cell.limits),
            "attempted": len(done) * B, "failed": failed,
            "memory_peak_bytes": memory_peak,
            "times": {"setup": setup_s, "window": window_s,
                      "after the window": t_ref - t0 - window_s,
                      "reference": time.perf_counter() - t_ref}}


def sample(done: List[Dict], seed: int, n: int, B: int):
    """``n`` finished requests ``(batch record, row)`` drawn from the
    seed, the first one from a batch of the longest prompts served."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4]))
    longest = max(d["length"] for d in done)
    first = next(d for d in done if d["length"] == longest)
    picks = [(first, int(rng.integers(B)))]
    flat = [(d, r) for d in done for r in range(B)
            if (d["index"], r) != (first["index"], picks[0][1])]
    for i in rng.choice(len(flat), size=min(n - 1, len(flat)),
                        replace=False):
        picks.append(flat[int(i)])
    return picks
