"""Coded training: ``CodedSession.external_step`` over a window of steps.

Set-up builds one session (the cluster, the planner's code, the mode and
codec, the optimizer) with the configuration as stated, writes the run's
weights into its parameters, points its per-part data streams at the
run's parts, and drives the first steps through the window's own call;
their losses, the optimizer's first moment after step 1 and each
parameter's change after the followed steps are read for the check.
The window then runs steps until ``--seconds`` have passed and closes at
the end of the last one.  Every step's parts are fresh (seed, step,
part) tokens and its completion set is drawn from the seed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, data, profiling, spec, weights, work
from portbench.reference import train as ref_train

ADAM_B1 = 0.9


class _Part:
    """Dataset part ``k``: the rows of the current step, the same on
    every worker that holds the part (the session asks once per holder)."""

    def __init__(self, k: int, run: "_Data"):
        self.k, self.run = k, run

    def next_batch(self) -> Dict[str, np.ndarray]:
        t, g = self.run.part(self.k)
        return {"tokens": t, "targets": g,
                "weights": np.ones(t.shape, np.float32)}


class _Data:
    def __init__(self, seed: int, tr: Dict, vocab: int):
        self.seed, self.tr, self.vocab, self.step = seed, tr, vocab, 0

    def part(self, k: int):
        return data.part_tokens(self.seed, self.step, k,
                                self.tr["part_batch"], self.tr["seq_len"],
                                self.vocab)


def build(cell, seed: int, device):
    """The session of the cell, holding the run's weights and data."""
    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme

    m, tr = cell.model, cell.traffic
    cl = tr["cluster"]
    session = CodedSession(
        CodedCluster.homogeneous(cl["n_edges"], cl["n_workers"]),
        spec.model_config(m),
        planner=planner_for_scheme(tr["scheme"], tr["s_e"], tr["s_w"]),
        mode=tr["mode"], seq_len=tr["seq_len"], part_batch=tr["part_batch"],
        optimizer=tr["optimizer"], lr=tr["lr"],
        total_steps=tr["total_steps"], warmup_steps=tr["warmup_steps"],
        grad_clip=tr["grad_clip"], grad_block=tr["grad_block"],
        grad_compression=tr["grad_compression"], seed=seed, verbose=False,
        device=device)
    if session.code.K != tr["K"]:
        raise RuntimeError(f"the planner chose K={session.code.K}, the "
                           f"traffic states K={tr['K']}")
    have = {k: tuple(v.shape) for k, v in
            weights.flat_leaves(session.params).items()}
    want = weights.param_shapes(m)
    if have != want:
        raise RuntimeError(f"the program's parameters {have} are not the "
                           f"layout the benchmark draws {want}")
    for k, v in weights.flat_leaves(session.params).items():
        weights.fill_(v, k, seed)
    feed = _Data(seed, tr, m["vocab"])
    session.streams = [_Part(k, feed) for k in range(tr["K"])]
    return session, feed


def _norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float()))
            for k, v in weights.flat_leaves(tree).items()}


def _change(session, seed: int) -> Dict[str, float]:
    out = {}
    with torch.no_grad():
        for k, v in weights.flat_leaves(session.params).items():
            p0 = weights.draw(k, tuple(v.shape), seed, v.device, v.dtype)
            out[k] = float(torch.linalg.vector_norm((v - p0).float()))
            del p0
    return out


def start(cell, seed: int, device):
    """Set-up through the first steps → (session, the step function, the
    program's readings for the check)."""
    tr = cell.traffic
    session, feed = build(cell, seed, device)
    cl = tr["cluster"]

    def step() -> float:
        fast_e, fast_w = data.completion_set(
            seed, feed.step, cl["n_edges"], cl["n_workers"], tr["s_e"],
            tr["s_w"])
        metrics = session.external_step(fast_e, fast_w)
        feed.step += 1
        return float(metrics["loss"])

    losses: List[float] = []
    prog: Dict = {}
    for s in range(tr["first_steps"]):
        losses.append(step())
        if s == 0:  # AdamW's first moment is (1 - β1) · the clipped grad
            prog["grad_norms"] = {k: v / (1 - ADAM_B1) for k, v in
                                  _norms(session.opt_state["m"]).items()}
        if s + 1 == tr["ref_steps"]:
            prog["change"] = _change(session, seed)
    prog["losses"] = losses[: tr["ref_steps"]]
    return session, step, prog


def run(cell, seed: int, seconds: float, traced: bool, device,
        sync, t_start: float) -> Dict:
    tr, m = cell.traffic, cell.model
    cl = tr["cluster"]
    session, step, prog = start(cell, seed, device)
    sync()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    ends, failed = [], 0
    while time.perf_counter() - t0 < seconds:
        if not np.isfinite(step()):
            failed += 1
        ends.append(time.perf_counter())
    sync()
    window_s = time.perf_counter() - t0
    rows = tr["K"] * tr["part_batch"]  # decoded rows a step
    computed_rows = (cl["n_edges"] * cl["n_workers"] * session.code.load
                     * tr["part_batch"])
    rec: Dict = {
        "setup_s": setup_s, "window_s": window_s, "steps": len(ends),
        "tokens": len(ends) * rows * tr["seq_len"],
        "flops": len(ends) * work.train_step_flops(m, computed_rows,
                                                   tr["seq_len"]),
        "model": m, "traffic": tr, "computed_rows": computed_rows,
        "leaf_sizes": {k: v.numel() for k, v in
                       weights.flat_leaves(session.params).items()},
    }
    if traced:
        rec["trace"] = profiling.profile(step, tr["profile_steps"], sync)
    t_ref = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    session = step = None  # the program's state goes before the reference
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = ref_train.run(m, tr, seed, tr["ref_steps"], device)
    checks = check.training(prog, want, cell.limits)
    return {"records": rec, "checks": checks, "attempted": len(ends),
            "failed": failed, "memory_peak_bytes": memory_peak,
            "times": {"setup": setup_s, "window": window_s,
                      "after the window": t_ref - t0 - window_s,
                      "reference": time.perf_counter() - t_ref}}
