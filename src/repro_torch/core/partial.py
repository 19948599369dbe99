"""Partial-result / multi-message gradient coding (beyond-paper).

The paper (§III end) notes that "accelerative single-layer gradient
coding techniques like utilizing partial computing results [18]
(Ozfatura et al.) can also be combined in coding between workers and
edge nodes".  This module implements that combination: each worker
sends a message after EVERY part it finishes (in its assignment order)
instead of one message at the end.  The edge can then decode as soon as
any prefix-pattern covering its part-set arrives — strictly earlier in
expectation than waiting for the fastest f_w full results.

Message t of worker (i,j) is the coded combination of its first t
parts; the edge solves, over the received prefix lengths {t_j}, for
weights c_{j,t} with  Σ_j Σ_t c_{j,t}·M_{j,t} = b_i  restricted to the
edge's parts — a small least-squares per iteration, same machinery as
eq. (24) with an enlarged (Σ t_j) × n_i system.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hgc import HGCCode

_RTOL = 1e-8


def worker_prefix_messages(
    code: HGCCode, i: int, j: int, g_parts: np.ndarray
) -> np.ndarray:
    """(D, dim): message t = coded combo of the worker's first t parts."""
    coeff = code.worker_coeffs(i, j)  # (K,)
    order = code.assignment.worker_parts(i, j)
    msgs = []
    acc = np.zeros_like(g_parts[0])
    for t, k in enumerate(order):
        acc = acc + coeff[k] * g_parts[k]
        msgs.append(acc.copy())
    return np.stack(msgs)


def prefix_coeff_matrix(code: HGCCode, i: int) -> np.ndarray:
    """(m_i·D, K): coefficient rows of every prefix message of edge i."""
    rows = []
    for j in range(code.topo.m[i]):
        coeff = code.worker_coeffs(i, j)
        order = code.assignment.worker_parts(i, j)
        acc = np.zeros(code.K)
        for k in order:
            acc = acc.copy()
            acc[k] += coeff[k]
            rows.append(acc.copy())
    return np.stack(rows)


def edge_decode_from_prefixes(
    code: HGCCode,
    i: int,
    prefix_lengths: Sequence[int],  # parts finished per worker (0..D)
    messages: Dict[int, np.ndarray],  # worker j → (t_j, dim) prefixes
) -> Optional[np.ndarray]:
    """Decode G_i from partial results if the received system spans b_i.

    Returns None when the prefixes cannot yet span (need more results).
    """
    D = code.load
    M = prefix_coeff_matrix(code, i)  # (m_i·D, K)
    live_rows: List[int] = []
    stacked: List[np.ndarray] = []
    for j, t_j in enumerate(prefix_lengths):
        for t in range(t_j):
            live_rows.append(j * D + t)
            stacked.append(messages[j][t])
    if not live_rows:
        return None
    A = M[live_rows]  # (R, K)
    target = code.B.matrix[i]  # b_i
    sol, *_ = np.linalg.lstsq(A.T, target, rcond=None)
    if np.max(np.abs(sol @ A - target)) > _RTOL:
        return None
    out = np.zeros_like(stacked[0])
    for w, msg in zip(sol, stacked):
        out = out + w * msg
    return out


def earliest_decode_progress(
    code: HGCCode, i: int, arrival_order: Sequence[Tuple[int, int]]
) -> int:
    """How many prefix messages (in arrival order) until edge i decodes.

    ``arrival_order``: sequence of (worker j, prefix index t) events.
    Returns the 1-based count, or -1 if never decodable.
    Used by tests/benchmarks to show the speedup over full-result HGC.
    """
    D = code.load
    M = prefix_coeff_matrix(code, i)
    target = code.B.matrix[i]
    lens = [0] * code.topo.m[i]
    for n_arrived, (j, t) in enumerate(arrival_order, start=1):
        lens[j] = max(lens[j], t + 1)
        rows = [jj * D + tt for jj in range(code.topo.m[i])
                for tt in range(lens[jj])]
        A = M[rows]
        sol, *_ = np.linalg.lstsq(A.T, target, rcond=None)
        if np.max(np.abs(sol @ A - target)) <= _RTOL:
            return n_arrived
    return -1
