"""Hierarchical cluster topology descriptions.

The paper's system is a master <-> n edge nodes <-> m_i workers tree
(Fig. 1).  ``Topology`` is the single source of truth consumed by the
assignment/encoding/decoding modules, the runtime model, JNCSS, the
simulator and the distributed launcher (where edges map to pods and
workers map to data-parallel shard groups).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    """A 2-level master/edge/worker tree.

    Attributes:
      m: tuple of per-edge worker counts ``(m_1, ..., m_n)``.
    """

    m: Tuple[int, ...]

    def __post_init__(self):
        if len(self.m) == 0:
            raise ValueError("topology needs at least one edge node")
        if any(mi <= 0 for mi in self.m):
            raise ValueError(f"worker counts must be positive, got {self.m}")

    @property
    def n(self) -> int:
        """Number of edge nodes."""
        return len(self.m)

    @property
    def m_min(self) -> int:
        """min_i m_i — the paper's ``m`` in straggler-tolerance domains."""
        return min(self.m)

    @property
    def total_workers(self) -> int:
        """Σ_i m_i."""
        return sum(self.m)

    def workers_of(self, i: int) -> int:
        """Worker count of edge node ``E_{i+1}`` (0-indexed here)."""
        return self.m[i]

    def worker_ids(self) -> List[Tuple[int, int]]:
        """All (edge, worker) index pairs, 0-indexed, row-major."""
        return [(i, j) for i in range(self.n) for j in range(self.m[i])]

    def flat_index(self, i: int, j: int) -> int:
        """Flatten (edge i, worker j) into a global worker index."""
        return sum(self.m[:i]) + j

    @staticmethod
    def uniform(n: int, m: int) -> "Topology":
        """n edges, m workers each (the paper's simulation setting)."""
        return Topology(m=(m,) * n)


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Straggler tolerance levels ``(s_e, s_w)``.

    ``s_e ∈ [0 : n)`` straggling edge nodes, ``s_w ∈ [0 : min_i m_i)``
    straggling workers per edge node are tolerated (paper §II-A).
    """

    s_e: int
    s_w: int

    def validate(self, topo: Topology) -> "Tolerance":
        if not (0 <= self.s_e < topo.n):
            raise ValueError(f"s_e={self.s_e} outside [0:{topo.n})")
        if not (0 <= self.s_w < topo.m_min):
            raise ValueError(f"s_w={self.s_w} outside [0:{topo.m_min})")
        return self

    @property
    def f_e(self) -> int:
        raise AttributeError("use num_fast_edges(topo) — f_e depends on n")

    def num_fast_edges(self, topo: Topology) -> int:
        return topo.n - self.s_e

    def num_fast_workers(self, topo: Topology, i: int) -> int:
        return topo.m[i] - self.s_w

    def s_w_of(self, i: int) -> int:
        """Worker tolerance at edge ``i`` — uniform here; the grouped
        tolerance (:class:`repro_torch.core.grouping.GroupTolerance`) overrides
        this per edge.  Decode paths call this instead of ``.s_w`` so
        both tolerance kinds ride the same code."""
        return self.s_w


def straggler_pattern_valid(
    topo: Topology,
    tol: Tolerance,
    edge_stragglers: Sequence[int],
    worker_stragglers: Sequence[Sequence[int]],
) -> bool:
    """True iff the given straggler pattern is within (s_e, s_w) tolerance.

    ``worker_stragglers[i]`` lists straggling workers of edge i.  Workers
    under a straggling edge are implicated (paper §I) and do not count
    against s_w.
    """
    if len(set(edge_stragglers)) > tol.s_e:
        return False
    for i in range(topo.n):
        if i in edge_stragglers:
            continue
        if len(set(worker_stragglers[i])) > tol.s_w:
            return False
    return True
