"""Theorem 1 / Corollary 1 / Corollary 2 — the computational trade-off.

All quantities follow paper §II-B.  ``D`` is the number of the ``K``
disjoint sub-datasets each worker processes ("computational load").
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Sequence

from repro_torch.core.topology import Tolerance, Topology


def min_load_fraction(topo: Topology, tol: Tolerance) -> Fraction:
    """Theorem 1 lower bound on D/K: (s_e+1)(s_w+1) / Σ_i m_i."""
    tol.validate(topo)
    return Fraction((tol.s_e + 1) * (tol.s_w + 1), topo.total_workers)


def min_load(topo: Topology, tol: Tolerance, K: int) -> int:
    """Smallest integer D satisfying Theorem 1 for a given K."""
    frac = min_load_fraction(topo, tol)
    return math.ceil(frac * K)


def achievable_load(topo: Topology, tol: Tolerance, K: int) -> int:
    """Load of the HGC construction, eq. (23): D = K(s_e+1)(s_w+1)/Σm_i.

    Raises if the construction's divisibility requirements fail (callers
    should pick K via :func:`compatible_K`).
    """
    tol.validate(topo)
    num = K * (tol.s_e + 1) * (tol.s_w + 1)
    den = topo.total_workers
    if num % den != 0:
        raise ValueError(
            f"K={K} incompatible: K(s_e+1)(s_w+1)={num} not divisible by "
            f"Σm_i={den}; use compatible_K()"
        )
    return num // den


def compatible_K(topo: Topology, tol: Tolerance, at_least: int = 1) -> int:
    """Smallest K ≥ at_least for which the HGC construction is integral.

    Requirements (paper eqs (15), (18)):
      * n_i = K(s_e+1) m_i / Σm_i integral for all i,
      * D   = n_i (s_w+1) / m_i  integral for all i (same D by construction).
    """
    tol.validate(topo)
    K = max(1, at_least)
    while True:
        if _construction_integral(topo, tol, K):
            return K
        K += 1


def _construction_integral(topo: Topology, tol: Tolerance, K: int) -> bool:
    tot = topo.total_workers
    for mi in topo.m:
        num_ni = K * (tol.s_e + 1) * mi
        if num_ni % tot != 0:
            return False
        ni = num_ni // tot
        if (ni * (tol.s_w + 1)) % mi != 0:
            return False
    return True


def feasible(topo: Topology, tol: Tolerance) -> bool:
    """Paper §II-B feasibility: Σ_{i∈F,|F|=f_e} m_i (s_e+1) / Σ m_i ≥ 1.

    Evaluated at the worst case F (the f_e edges with the *fewest*
    workers), which is the binding case.
    """
    tol.validate(topo)
    f_e = topo.n - tol.s_e
    worst = sum(sorted(topo.m)[:f_e])
    return worst * (tol.s_e + 1) >= topo.total_workers


def conventional_load_fraction(topo: Topology, tol: Tolerance) -> Fraction:
    """Corollary 1, eq. (9): load of single-layer coding at equal tolerance.

    A single-layer worker↔master code must tolerate
    s_max = max_{|S_e|=s_e} Σ_{i∈S_e} m_i + (n−s_e) s_w
    worker stragglers, hence D_con/K = (s_max + 1)/Σ m_i.
    """
    tol.validate(topo)
    worst_edges = sum(sorted(topo.m, reverse=True)[: tol.s_e])
    s_max = worst_edges + (topo.n - tol.s_e) * tol.s_w
    return Fraction(s_max + 1, topo.total_workers)


def hgc_vs_conventional_savings(topo: Topology, tol: Tolerance) -> Fraction:
    """Load ratio D_hgc / D_con  (<1 whenever s_e>0 or heterogeneous)."""
    return min_load_fraction(topo, tol) / conventional_load_fraction(topo, tol)


def multilayer_min_load_fraction(
    layer_stragglers: Sequence[int], total_workers: int
) -> Fraction:
    """Corollary 2: D/K ≥ Π_l (s_l + 1) / W for an L-layer tree."""
    if total_workers <= 0:
        raise ValueError("total_workers must be positive")
    num = 1
    for s in layer_stragglers:
        if s < 0:
            raise ValueError("straggler counts must be non-negative")
        num *= s + 1
    return Fraction(num, total_workers)
