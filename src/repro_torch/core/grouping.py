"""Heterogeneity-aware grouped HGC — Wang et al. (arXiv:1901.09339) flavor.

The paper's two-layer code carries ONE worker tolerance ``s_w`` for every
edge.  On intra-edge-heterogeneous clusters that is wasteful: an edge
whose workers are uniformly fast gains nothing from worker redundancy,
while an edge with a heavy straggler tail wants a lot of it.  Following
the grouping idea of Wang et al. (group workers by capability, give each
group its own tolerance), we let every edge — the natural group of the
hierarchical topology — carry its own worker tolerance ``s_w^i``:

  * layer 1 is UNCHANGED (``B`` at tolerance ``s_e``, cyclic eq. 15/16
    placement — Condition 1 only involves the edge layer),
  * layer 2 builds each ``D̄^i`` at its own ``s_w^i`` (Condition 2 is
    per-edge), so the per-worker load becomes per-edge:

        D_i = n_i (s_w^i + 1) / m_i = K (s_e + 1)(s_w^i + 1) / Σ m_j .

Exactness: any ≤ s_e straggling edges plus ≤ s_w^i straggling workers
under each surviving edge i decode the exact gradient sum — the decode
is the SAME two-stage λ pipeline, so ``collapsed_weights`` (and with it
``dist/grad_sync``'s runtime-λ operand and the zero-recompile replan)
work unchanged.

:func:`plan_grouped` is the matching planner core: the per-edge choice
decouples (D_i depends only on edge i's own ``s_w^i``), so the joint
optimum is a per-edge argmin inside the JNCSS ``s_e`` grid — and its
expected time is never worse than uniform JNCSS (the uniform vector is
always a candidate).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tradeoff
from repro_torch.core.assignment import Assignment
from repro_torch.core.encoding import (
    LinearCode,
    build_random_code,
    build_replication_code,
)
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import ClusterParams, kth_min
from repro_torch.core.topology import Tolerance, Topology


@dataclasses.dataclass(frozen=True)
class GroupTolerance:
    """Per-edge worker tolerances ``(s_e, (s_w^1, ..., s_w^n))``.

    Duck-compatible with :class:`~repro_torch.core.topology.Tolerance` where
    the session/decode seam reads it: ``.s_e``, ``.s_w`` (the uniform
    guarantee — the minimum over edges) and ``.s_w_of(i)``.
    """

    s_e: int
    s_w_vec: Tuple[int, ...]

    @property
    def s_w(self) -> int:
        """The uniformly guaranteed worker tolerance: min_i s_w^i."""
        return min(self.s_w_vec)

    def s_w_of(self, i: int) -> int:
        return self.s_w_vec[i]

    def validate(self, topo: Topology) -> "GroupTolerance":
        if len(self.s_w_vec) != topo.n:
            raise ValueError(
                f"s_w_vec has {len(self.s_w_vec)} entries for "
                f"{topo.n} edges"
            )
        if not (0 <= self.s_e < topo.n):
            raise ValueError(f"s_e={self.s_e} outside [0:{topo.n})")
        for i, s in enumerate(self.s_w_vec):
            if not (0 <= s < topo.m[i]):
                raise ValueError(
                    f"s_w^{i}={s} outside [0:{topo.m[i]}) at edge {i}"
                )
        # layer-1 feasibility only involves s_e (paper §II-B)
        if not tradeoff.feasible(topo, Tolerance(self.s_e, 0)):
            raise ValueError(
                f"s_e={self.s_e} infeasible for topology {topo.m}"
            )
        return self

    def num_fast_edges(self, topo: Topology) -> int:
        return topo.n - self.s_e

    def num_fast_workers(self, topo: Topology, i: int) -> int:
        return topo.m[i] - self.s_w_vec[i]


def compatible_K_grouped(
    topo: Topology, gtol: GroupTolerance, at_least: int = 1
) -> int:
    """Smallest K ≥ at_least with integral n_i AND per-edge D_i."""
    gtol.validate(topo)
    K = max(1, at_least)
    W = topo.total_workers
    while True:
        ok = True
        for i, mi in enumerate(topo.m):
            num_ni = K * (gtol.s_e + 1) * mi
            if num_ni % W != 0:
                ok = False
                break
            ni = num_ni // W
            if (ni * (gtol.s_w_vec[i] + 1)) % mi != 0:
                ok = False
                break
        if ok:
            return K
        K += 1


def build_grouped_assignment(
    topo: Topology, gtol: GroupTolerance, K: int
) -> Assignment:
    """Cyclic assignment with a per-edge worker cover ``s_w^i + 1``.

    Layer 1 is the paper's eqs (15)/(16) verbatim; layer 2 uses the same
    stride-D_i cyclic windows per edge — m_i contiguous windows of
    length D_i wrap the n_i local parts exactly (s_w^i + 1) times, so
    each edge's local cover is exact at its own tolerance.
    """
    gtol.validate(topo)
    W = topo.total_workers
    edge_parts: List[Tuple[int, ...]] = []
    offset = 0
    for i in range(topo.n):
        num = K * (gtol.s_e + 1) * topo.m[i]
        if num % W != 0:
            raise ValueError(
                f"n_i for edge {i} not integral (K={K}); use "
                f"compatible_K_grouped()"
            )
        ni = num // W
        if ni > K:
            raise ValueError(
                f"edge {i} would be assigned n_i={ni} > K={K} parts"
            )
        edge_parts.append(tuple((offset + t) % K for t in range(ni)))
        offset += ni
    assert offset == K * (gtol.s_e + 1)

    worker_local: List[Tuple[Tuple[int, ...], ...]] = []
    for i in range(topo.n):
        ni = len(edge_parts[i])
        mi = topo.m[i]
        num = ni * (gtol.s_w_vec[i] + 1)
        if num % mi != 0:
            raise ValueError(
                f"D_i for edge {i} not integral (n_i={ni}, m_i={mi}, "
                f"s_w^i={gtol.s_w_vec[i]}); use compatible_K_grouped()"
            )
        D_i = num // mi
        worker_local.append(tuple(
            tuple((j * D_i + t) % ni for t in range(D_i))
            for j in range(mi)
        ))

    asg = Assignment(
        topo=topo, tol=gtol, K=K,
        edge_parts=tuple(edge_parts),
        worker_local=tuple(worker_local),
    )
    # per-edge cover invariants (Assignment._check_covers assumes the
    # uniform tolerance, so verify the grouped covers here)
    cover = asg.parts_per_edge_cover()
    bad = {k: c for k, c in cover.items() if c != gtol.s_e + 1}
    if bad:
        raise AssertionError(f"edge cover != s_e+1: {bad}")
    for i in range(topo.n):
        want = gtol.s_w_vec[i] + 1
        bad = {l: c for l, c in asg.local_cover(i).items() if c != want}
        if bad:
            raise AssertionError(
                f"edge {i} local cover != s_w^i+1={want}: {bad}"
            )
    return asg


class GroupedHGCCode(HGCCode):
    """Two-layer code with per-edge worker tolerances.

    Same frozen-dataclass fields as :class:`HGCCode`; ``tol`` holds a
    :class:`GroupTolerance`.  Every decode method of the base class
    already resolves the worker tolerance through ``tol.s_w_of(i)``, so
    only construction and the (now per-edge) load accessors differ.
    """

    @staticmethod
    def build(
        topo: Topology,
        tol: GroupTolerance,
        K: Optional[int] = None,
        seed: int = 0,
        construction: str = "random",
    ) -> "GroupedHGCCode":
        if construction != "random":
            raise ValueError(
                "grouped codes support only the random construction "
                "(FRC divisibility is a uniform-tolerance property)"
            )
        tol.validate(topo)
        if K is None:
            K = compatible_K_grouped(
                topo, tol, at_least=topo.total_workers
            )
        asg = build_grouped_assignment(topo, tol, K)
        b_supports = tuple(
            tuple(sorted(set(p))) for p in asg.edge_parts
        )
        if tol.s_e == 0:
            B = build_replication_code(b_supports, K)
        else:
            B = build_random_code(b_supports, K, tol.s_e, seed=seed)
        dbars: List[LinearCode] = []
        for i in range(topo.n):
            ni = asg.n_i(i)
            sup = tuple(
                tuple(sorted(set(w))) for w in asg.worker_local[i]
            )
            if tol.s_w_vec[i] == 0:
                dbars.append(build_replication_code(sup, ni))
            else:
                dbars.append(build_random_code(
                    sup, ni, tol.s_w_vec[i], seed=seed + 1 + i
                ))
        return GroupedHGCCode(
            topo=topo, tol=tol, K=K, assignment=asg, B=B,
            Dbar=tuple(dbars), construction="random",
        )

    @property
    def loads(self) -> Tuple[int, ...]:
        """Per-edge worker load D_i."""
        return tuple(
            len(self.assignment.worker_local[i][0])
            for i in range(self.topo.n)
        )

    @property
    def load(self) -> int:
        """Bottleneck per-worker load max_i D_i (scalar summary)."""
        return max(self.loads)

    @property
    def load_array(self) -> np.ndarray:
        """Flat per-worker loads in ``topo.worker_ids()`` order."""
        return np.repeat(
            np.asarray(self.loads, np.float64), np.asarray(self.topo.m)
        )


# ----------------------------------------------------------------------
# the grouped planner core (heterogeneity-aware JNCSS generalization)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GroupedPlanResult:
    s_e: int
    s_w_vec: Tuple[int, ...]
    T_tol: float
    # model (fractional) per-edge loads at the requested K
    D_vec: Tuple[float, ...]


def plan_grouped(
    params: ClusterParams,
    K: int,
    only_compatible: bool = False,
) -> GroupedPlanResult:
    """Jointly pick ``(s_e, s_w^1..s_w^n)`` minimizing expected time.

    Because D_i = K(s_e+1)(s_w^i+1)/W depends only on edge i's own
    tolerance, the inner problem decouples: per edge, pick the s_w^i
    minimizing A_i + (m_i−s_w^i)-th min of B_(i,j)(D_i); the system time
    is then the (n−s_e)-th min over the per-edge optima, and the outer
    s_e grid is JNCSS's.  ``only_compatible=True`` restricts the search
    to tolerances whose construction is integral at exactly this K
    (the scheme factory's fixed-K mode).
    """
    topo = params.topo
    W = topo.total_workers
    A = params.expected_edge_upload()
    best = None
    for s_e in range(topo.n):
        if not tradeoff.feasible(topo, Tolerance(s_e, 0)):
            continue
        if only_compatible and any(
            (K * (s_e + 1) * mi) % W != 0 for mi in topo.m
        ):
            continue
        s_w_vec: List[int] = []
        edge_T = np.empty(topo.n)
        D_vec: List[float] = []
        off = 0
        infeasible = False
        for i in range(topo.n):
            mi = topo.m[i]
            best_i = None
            for s_w in range(mi):
                D = K * (s_e + 1) * (s_w + 1) / W
                if only_compatible:
                    ni = K * (s_e + 1) * mi // W
                    if (ni * (s_w + 1)) % mi != 0:
                        continue
                B = params.expected_worker_total(D)[off : off + mi]
                T_i = A[i] + kth_min(B, mi - s_w)
                if best_i is None or T_i < best_i[0]:
                    best_i = (float(T_i), s_w, D)
            if best_i is None:
                infeasible = True
                break
            edge_T[i] = best_i[0]
            s_w_vec.append(best_i[1])
            D_vec.append(best_i[2])
            off += mi
        if infeasible:
            continue
        T = float(kth_min(edge_T, topo.n - s_e))
        if best is None or T < best[0]:
            best = (T, s_e, tuple(s_w_vec), tuple(D_vec))
    if best is None:
        raise ValueError(
            f"no feasible grouped tolerance for topology {topo.m} "
            f"at K={K}"
        )
    T, s_e, s_w_vec, D_vec = best
    return GroupedPlanResult(
        s_e=s_e, s_w_vec=s_w_vec, T_tol=T, D_vec=D_vec
    )


def price_grouped(
    params: ClusterParams,
    gtol: GroupTolerance,
    loads: Sequence[float],
) -> float:
    """Expected iteration time T̂ (ms) of a grouped code at its per-edge
    deployed loads — the grouped counterpart of
    :func:`repro.dist.elastic.price_tolerance`."""
    topo = params.topo
    D_flat = np.repeat(
        np.asarray(loads, np.float64), np.asarray(topo.m)
    )
    B = params.expected_worker_total(D_flat)
    A = params.expected_edge_upload()
    scores = np.empty(topo.n)
    off = 0
    for i in range(topo.n):
        mi = topo.m[i]
        scores[i] = A[i] + kth_min(
            B[off : off + mi], mi - gtol.s_w_vec[i]
        )
        off += mi
    return float(kth_min(scores, topo.n - gtol.s_e))
