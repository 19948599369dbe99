"""Inputs from ``--seed``: token parts, completion sets, prompts.

Everything here is a function of the seed and an index, so the harness
and the reference draw the same inputs independently, and a run's work
(sizes and counts) never depends on the seed: only the token values
and the completion sets do.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(k) for k in key]))


def part_tokens(seed: int, step: int, part: int, rows: int, seq: int,
                vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, next-token targets), each (rows, seq) int64, of dataset
    part ``part`` at training step ``step``: uniform over the vocabulary."""
    x = _rng(seed, 1, step, part).integers(0, vocab, size=(rows, seq + 1))
    return x[:, :-1], x[:, 1:]


def completion_set(seed: int, step: int, n_edges: int, n_workers: int,
                   s_e: int, s_w: int
                   ) -> Tuple[Tuple[int, ...], List[Tuple[int, ...]]]:
    """The edges and, for every edge, the workers whose messages arrive
    first at step ``step``: ``s_e`` edges and ``s_w`` workers of each
    edge straggle, drawn uniformly."""
    rng = _rng(seed, 2, step)
    slow_e = set(rng.choice(n_edges, size=s_e, replace=False).tolist())
    fast_e = tuple(i for i in range(n_edges) if i not in slow_e)
    fast_w = []
    for _ in range(n_edges):
        slow_w = set(rng.choice(n_workers, size=s_w, replace=False).tolist())
        fast_w.append(tuple(j for j in range(n_workers) if j not in slow_w))
    return fast_e, fast_w


def cyclic_assignment(n_edges: int, n_workers: int, s_e: int, s_w: int,
                      K: int) -> List[List[Tuple[int, ...]]]:
    """``parts[i][j]``: the parts worker ``j`` of edge ``i`` holds, in
    order — the paper's cyclic placement (eqs. 15–19) on a uniform
    topology: edge ``i`` holds ``n_i = K (s_e+1) / n`` parts from offset
    ``i · n_i`` (mod K), its worker ``j`` the ``D = n_i (s_w+1) / m`` of
    them from local offset ``j · D`` (mod n_i)."""
    n_i = K * (s_e + 1) // n_edges
    D = n_i * (s_w + 1) // n_workers
    out = []
    for i in range(n_edges):
        edge = [(i * n_i + t) % K for t in range(n_i)]
        out.append([tuple(edge[(j * D + t) % n_i] for t in range(D))
                    for j in range(n_workers)])
    return out


def prompt_tokens(seed: int, batch_index: int, batch: int, length: int,
                  vocab: int) -> np.ndarray:
    """The prompts (batch, length) int64 of window batch ``batch_index``."""
    return _rng(seed, 3, batch_index).integers(0, vocab,
                                               size=(batch, length))
