"""Data-partition assignment maps — paper eqs (15), (16), (18), (19).

The K disjoint sub-datasets are assigned cyclically:
  * edge node E_i receives n_i = K(s_e+1) m_i / Σ m_i parts           (15)
    at global offset Σ_{j<i} n_j (mod K)                               (16)
  * worker W_(i,j) receives D = n_i (s_w+1) / m_i of E_i's parts      (18)
    at local offset (j-1)·D (mod n_i)                                  (19)

All indices here are 0-based.  The cyclic construction covers every part
exactly (s_e+1) times across edges, and every edge-local part exactly
(s_w+1) times across that edge's workers — which is what makes the
two-layer code of §III feasible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.topology import Tolerance, Topology
from repro_torch.core import tradeoff


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Materialized assignment maps for a (topology, tolerance, K) triple."""

    topo: Topology
    tol: Tolerance
    K: int
    # edge_parts[i]  : ordered list of global part ids held by edge i (len n_i)
    edge_parts: Tuple[Tuple[int, ...], ...]
    # worker_local[i][j] : ordered local indices (into edge_parts[i]) of
    #                      worker (i, j)'s parts (len D)
    worker_local: Tuple[Tuple[Tuple[int, ...], ...], ...]

    @property
    def D(self) -> int:
        """Per-worker computational load."""
        return len(self.worker_local[0][0])

    def n_i(self, i: int) -> int:
        return len(self.edge_parts[i])

    def worker_parts(self, i: int, j: int) -> Tuple[int, ...]:
        """Global part ids processed by worker (i, j)."""
        ep = self.edge_parts[i]
        return tuple(ep[l] for l in self.worker_local[i][j])

    def parts_per_edge_cover(self) -> Dict[int, int]:
        """How many edges hold each part (must be s_e+1 everywhere)."""
        cover: Dict[int, int] = {k: 0 for k in range(self.K)}
        for parts in self.edge_parts:
            seen = set()
            for p in parts:
                if p not in seen:  # duplicates within an edge count once
                    cover[p] += 1
                    seen.add(p)
        return cover

    def local_cover(self, i: int) -> Dict[int, int]:
        """How many of edge i's workers hold each local part (s_w+1)."""
        cover: Dict[int, int] = {l: 0 for l in range(self.n_i(i))}
        for locs in self.worker_local[i]:
            for l in set(locs):
                cover[l] += 1
        return cover


def build_assignment(topo: Topology, tol: Tolerance, K: int) -> Assignment:
    """Build the cyclic assignment of paper §III-A.

    Raises ``ValueError`` when (topo, tol, K) violates the construction's
    integrality requirements — pick K with :func:`tradeoff.compatible_K`.
    """
    tol.validate(topo)
    if not tradeoff.feasible(topo, tol):
        raise ValueError(
            f"(s_e={tol.s_e}, s_w={tol.s_w}) infeasible for topology {topo.m}: "
            "not enough workers among the slowest f_e edges (paper §II-B)"
        )
    tot = topo.total_workers
    edge_parts: List[Tuple[int, ...]] = []
    offset = 0
    for i in range(topo.n):
        num = K * (tol.s_e + 1) * topo.m[i]
        if num % tot != 0:
            raise ValueError(
                f"n_i for edge {i} not integral (K={K}); use compatible_K()"
            )
        ni = num // tot
        if ni > K:
            raise ValueError(
                f"edge {i} would be assigned n_i={ni} > K={K} parts; "
                "topology too skewed for this tolerance"
            )
        edge_parts.append(tuple((offset + t) % K for t in range(ni)))
        offset += ni
    # sanity: Σ n_i = K (s_e + 1)
    assert offset == K * (tol.s_e + 1)

    worker_local: List[Tuple[Tuple[int, ...], ...]] = []
    D_ref = None
    for i in range(topo.n):
        ni = len(edge_parts[i])
        mi = topo.m[i]
        num = ni * (tol.s_w + 1)
        if num % mi != 0:
            raise ValueError(
                f"D for edge {i} not integral (n_i={ni}, m_i={mi}); "
                "use compatible_K()"
            )
        D = num // mi
        if D_ref is None:
            D_ref = D
        elif D != D_ref:  # construction guarantees equality; guard anyway
            raise ValueError(f"unequal per-worker loads {D} != {D_ref}")
        rows = []
        for j in range(mi):
            rows.append(tuple((j * D + t) % ni for t in range(D)))
        worker_local.append(tuple(rows))

    asg = Assignment(
        topo=topo,
        tol=tol,
        K=K,
        edge_parts=tuple(edge_parts),
        worker_local=tuple(worker_local),
    )
    _check_covers(asg)
    return asg


def assignment_from_supports(
    topo: Topology,
    tol: Tolerance,
    K: int,
    edge_supports: Tuple[Tuple[int, ...], ...],
    worker_supports: Tuple[Tuple[Tuple[int, ...], ...], ...],
) -> Assignment:
    """Build an Assignment directly from code supports.

    Used by non-cyclic constructions (e.g. fractional repetition) where
    the code's support structure *defines* the data placement.
    ``worker_supports[i][j]`` are local indices into ``edge_supports[i]``.
    """
    asg = Assignment(
        topo=topo,
        tol=tol,
        K=K,
        edge_parts=edge_supports,
        worker_local=worker_supports,
    )
    _check_covers(asg)
    return asg


def _check_covers(asg: Assignment) -> None:
    """Internal invariants: exact (s_e+1)- and (s_w+1)-fold covers."""
    cover = asg.parts_per_edge_cover()
    want = asg.tol.s_e + 1
    bad = {k: c for k, c in cover.items() if c != want}
    if bad:
        raise AssertionError(f"edge cover != s_e+1={want}: {bad}")
    for i in range(asg.topo.n):
        lc = asg.local_cover(i)
        want_w = asg.tol.s_w + 1
        bad = {l: c for l, c in lc.items() if c != want_w}
        if bad:
            raise AssertionError(f"edge {i} local cover != s_w+1: {bad}")
