"""Communication–computation trade-off — Gholami et al. (arXiv:2502.18251)
flavor, restricted to the exact-decode HGC family.

Gholami et al. study hierarchical gradient coding under a *communication
budget*: the master may ingest fewer than ``n − s_e`` messages per
iteration if workers compute (and edges forward) more redundancy.  Their
dimension-reduction construction trades exactness for bandwidth, which
would break this repo's scalar-λ ``collapsed_weights`` seam — so here we
keep the exact HGC family and expose the same trade-off axis through
tolerance selection:

  * master ingests ``n − s_e`` edge messages,
  * edge ``i`` ingests ``m_i − s_w`` worker messages,
  * per-worker load is ``D = K (s_e+1)(s_w+1) / Σ m_i``.

Shrinking the message budgets forces the tolerances UP, which forces the
per-worker computation UP — the communication↔computation trade-off,
navigated by :func:`solve_comm_budget` and charted by
:func:`tradeoff_curve`.  Every point decodes exactly through the
unchanged two-stage λ pipeline, so replans stay zero-recompile.

:func:`pareto_front` is the generic non-dominated filter used by
``benchmarks/bench_pareto.py`` (all axes minimized; negate an axis to
maximize it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import jncss, tradeoff
from repro_torch.core.runtime_model import ClusterParams, kth_min
from repro_torch.core.topology import Tolerance


@dataclasses.dataclass(frozen=True)
class CommPoint:
    """One (tolerance → communication/computation) operating point."""

    s_e: int
    s_w: int
    D: float  # model per-worker load, eq (44)
    master_msgs: int  # edge→master messages ingested per iteration
    edge_msgs: int  # worst-case worker→edge messages at one edge
    T_hat: float  # expected iteration time at this point (ms)

    @property
    def tol(self) -> Tolerance:
        return Tolerance(self.s_e, self.s_w)


def enumerate_points(params: ClusterParams, K: int) -> List[CommPoint]:
    """All feasible (s_e, s_w) operating points with their comm/comp
    coordinates, in grid order."""
    topo = params.topo
    out: List[CommPoint] = []
    max_m = max(topo.m)
    for s_e in range(topo.n):
        for s_w in range(topo.m_min):
            tol = Tolerance(s_e, s_w)
            if not tradeoff.feasible(topo, tol):
                continue
            D = jncss.load_D(topo, K, s_e, s_w)
            scores, _ = jncss._edge_scores(params, D, s_w)
            out.append(CommPoint(
                s_e=s_e,
                s_w=s_w,
                D=D,
                master_msgs=topo.n - s_e,
                edge_msgs=max_m - s_w,
                T_hat=float(kth_min(scores, topo.n - s_e)),
            ))
    if not out:
        raise ValueError(f"no feasible tolerance for topology {topo.m}")
    return out


def _integral_at(topo, s_e: int, s_w: int, K: int) -> bool:
    """True iff the cyclic construction is integral at exactly this K."""
    W = topo.total_workers
    for mi in topo.m:
        num = K * (s_e + 1) * mi
        if num % W != 0:
            return False
        if ((num // W) * (s_w + 1)) % mi != 0:
            return False
    return True


def solve_comm_budget(
    params: ClusterParams,
    K: int,
    max_master_msgs: Optional[int] = None,
    max_edge_msgs: Optional[int] = None,
    integral_K: Optional[int] = None,
) -> CommPoint:
    """Cheapest exact point within the message budgets.

    Among feasible points with ``master_msgs ≤ max_master_msgs`` and
    ``edge_msgs ≤ max_edge_msgs`` (None = unconstrained), pick the one
    with minimal per-worker load D, breaking ties on expected time T̂
    (two points can share D — e.g. (s_e,s_w)=(1,0) and (0,1) — and then
    the cluster shape decides which is faster).  ``integral_K`` further
    restricts to tolerances whose construction is integral at that K
    (the scheme factory's fixed-K mode; planners instead adjust K after
    picking the tolerance).
    """
    pts = enumerate_points(params, K)
    ok = [
        p for p in pts
        if (max_master_msgs is None or p.master_msgs <= max_master_msgs)
        and (max_edge_msgs is None or p.edge_msgs <= max_edge_msgs)
        and (integral_K is None
             or _integral_at(params.topo, p.s_e, p.s_w, integral_K))
    ]
    if not ok:
        raise ValueError(
            f"no feasible tolerance within the message budgets "
            f"(master ≤ {max_master_msgs}, edge ≤ {max_edge_msgs}) for "
            f"topology {params.topo.m}"
        )
    return min(ok, key=lambda p: (p.D, p.T_hat))


def tradeoff_curve(params: ClusterParams, K: int) -> List[CommPoint]:
    """The communication→computation frontier: for each master message
    budget b = 1..n, the min-load point achievable within it (dropping
    budgets where relaxing buys nothing new)."""
    topo = params.topo
    out: List[CommPoint] = []
    for budget in range(1, topo.n + 1):
        try:
            p = solve_comm_budget(params, K, max_master_msgs=budget)
        except ValueError:
            continue
        if not out or p != out[-1]:
            out.append(p)
    return out


def pareto_front(rows: Sequence[Sequence[float]]) -> np.ndarray:
    """Boolean mask of non-dominated rows (every axis minimized).

    Row a dominates row b iff a ≤ b on all axes and a < b on at least
    one.  Duplicated rows are all kept (neither strictly dominates).
    Callers maximizing an axis should negate it first.
    """
    pts = np.asarray(rows, dtype=np.float64)
    if pts.ndim != 2:
        raise ValueError(f"expected 2-D rows, got shape {pts.shape}")
    n = pts.shape[0]
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        le = np.all(pts <= pts[i], axis=1)
        lt = np.any(pts < pts[i], axis=1)
        if np.any(le & lt):
            keep[i] = False
    return keep
