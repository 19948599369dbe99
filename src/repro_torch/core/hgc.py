"""Hierarchical Gradient Coding — paper §III, Algorithm 1.

``HGCCode`` materializes the full two-layer code:

  * layer 1: ``B ∈ R^{n×K}`` between master and edges (Condition 1),
  * layer 2: ``D̄^i ∈ R^{m_i×n_i}`` between edge ``E_i`` and its workers
    (Condition 2), expanded to ``D^i ∈ R^{m_i×K}`` per eq. (21).

Worker ``(i,j)`` transmits (eq. 22):

    G_ij = d^i_j · diag(g_1..g_K) · b_i^T = Σ_k d^i_jk b_ik g_k

so its *effective* per-part coefficient vector is ``d^i_j ⊙ b_i``.
Edge decode (eq. 25) folds ``c^i_F``; master decode (eq. 27) folds
``a_F``.  The fully-collapsed view used by the distributed runtime:

    g = Σ_{i∈F} a_i Σ_{j∈F_i} c^i_j G_ij = Σ_{(i,j)} λ_ij G_ij ,

with per-worker scalar weights ``λ_ij = a_i c^i_j`` that depend only on
the straggler pattern — so a tolerated node drop costs one host-side
linear solve and *zero* recompilation of the training step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tradeoff
from repro_torch.core.assignment import Assignment, build_assignment
from repro_torch.core.encoding import (
    LinearCode,
    build_frc_code,
    build_random_code,
    build_replication_code,
    cyclic_supports,
    frc_decode_weights,
)
from repro_torch.core.topology import Tolerance, Topology


@dataclasses.dataclass(frozen=True)
class HGCCode:
    """The two-layer hierarchical gradient code of Algorithm 1."""

    topo: Topology
    tol: Tolerance
    K: int
    assignment: Assignment
    B: LinearCode  # n × K, layer-1 (master↔edges)
    Dbar: Tuple[LinearCode, ...]  # per-edge m_i × n_i, layer-2
    construction: str = "random"

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def build(
        topo: Topology,
        tol: Tolerance,
        K: Optional[int] = None,
        seed: int = 0,
        construction: str = "random",
    ) -> "HGCCode":
        """Build the code; picks a compatible K automatically if omitted."""
        tol.validate(topo)
        if K is None:
            K = tradeoff.compatible_K(topo, tol, at_least=topo.total_workers)

        if construction == "frc":
            return HGCCode._build_frc(topo, tol, K)

        asg = build_assignment(topo, tol, K)
        # Layer 1: supports are exactly the edge part-sets (eq. 16).
        b_supports = tuple(tuple(sorted(set(p))) for p in asg.edge_parts)
        if tol.s_e == 0:
            # s_e=0 ⇒ each part on exactly one edge ⇒ replication code.
            B = build_replication_code(b_supports, K)
        else:
            B = build_random_code(b_supports, K, tol.s_e, seed=seed)

        dbars: List[LinearCode] = []
        for i in range(topo.n):
            ni = asg.n_i(i)
            sup = tuple(tuple(sorted(set(w))) for w in asg.worker_local[i])
            if tol.s_w == 0:
                dbars.append(build_replication_code(sup, ni))
            else:
                dbars.append(
                    build_random_code(sup, ni, tol.s_w, seed=seed + 1 + i)
                )
        return HGCCode(
            topo=topo,
            tol=tol,
            K=K,
            assignment=asg,
            B=B,
            Dbar=tuple(dbars),
            construction=construction,
        )

    @staticmethod
    def _build_frc(topo: Topology, tol: Tolerance, K: int) -> "HGCCode":
        """Fractional-repetition construction (beyond-paper conditioning).

        Requires (s_e+1) | n, (n/(s_e+1)) | K, and per edge
        (s_w+1) | m_i with (m_i/(s_w+1)) | n_i.  The data placement is
        *defined by* the FRC supports (group-partition, not cyclic).
        """
        from repro_torch.core.assignment import assignment_from_supports

        if tol.s_e == 0:
            sup = cyclic_supports(
                K, [K // topo.n] * topo.n
            )  # s_e=0: disjoint cover needs n | K
            if K % topo.n != 0:
                raise ValueError("frc with s_e=0 requires n | K")
            B = build_replication_code(sup, K)
        else:
            if not _frc_ok(topo.n, K, tol.s_e):
                raise ValueError(
                    f"frc layer-1 divisibility fails: n={topo.n}, K={K}, "
                    f"s_e={tol.s_e}"
                )
            B = build_frc_code(topo.n, K, tol.s_e)
        edge_supports = B.supports
        dbars: List[LinearCode] = []
        worker_supports = []
        for i in range(topo.n):
            ni = len(edge_supports[i])
            mi = topo.m[i]
            if tol.s_w == 0:
                if ni % mi != 0:
                    raise ValueError(f"frc s_w=0 requires m_i | n_i (edge {i})")
                sup = cyclic_supports(ni, [ni // mi] * mi)
                dbars.append(build_replication_code(sup, ni))
            else:
                if not _frc_ok(mi, ni, tol.s_w):
                    raise ValueError(
                        f"frc layer-2 divisibility fails at edge {i}: "
                        f"m_i={mi}, n_i={ni}, s_w={tol.s_w}"
                    )
                dbars.append(build_frc_code(mi, ni, tol.s_w))
            worker_supports.append(dbars[-1].supports)
        asg = assignment_from_supports(
            topo, tol, K, edge_supports, tuple(worker_supports)
        )
        return HGCCode(
            topo=topo,
            tol=tol,
            K=K,
            assignment=asg,
            B=B,
            Dbar=tuple(dbars),
            construction="frc",
        )

    # ------------------------------------------------------------------
    # Derived matrices
    # ------------------------------------------------------------------
    def D_expanded(self, i: int) -> np.ndarray:
        """``D^i ∈ R^{m_i×K}`` — eq. (21): D̄^i scattered onto global ids."""
        ni = self.assignment.n_i(i)
        out = np.zeros((self.topo.m[i], self.K), dtype=np.float64)
        ep = self.assignment.edge_parts[i]
        for local in range(ni):
            out[:, ep[local]] += self.Dbar[i].matrix[:, local]
        return out

    def worker_coeffs(self, i: int, j: int) -> np.ndarray:
        """Effective per-part coefficients of worker (i,j): d^i_j ⊙ b_i."""
        return self.D_expanded(i)[j] * self.B.matrix[i]

    @property
    def load(self) -> int:
        """Per-worker computational load D (meets Theorem 1 w/ equality)."""
        return self.assignment.D

    # ------------------------------------------------------------------
    # Encoding / decoding (numpy reference semantics)
    # ------------------------------------------------------------------
    def worker_encode(self, i: int, j: int, g_parts: np.ndarray) -> np.ndarray:
        """``G_ij`` from stacked per-part gradients ``g_parts (K, dim)``."""
        return self.worker_coeffs(i, j) @ g_parts

    def edge_decode_weights(
        self, i: int, fast_workers: Sequence[int]
    ) -> np.ndarray:
        """``c^i_F`` (len m_i, zero on stragglers) — eq. (24)."""
        s_w_i = self.tol.s_w_of(i)
        if len(set(fast_workers)) < self.topo.m[i] - s_w_i:
            raise ValueError(
                f"edge {i}: need ≥ {self.topo.m[i] - s_w_i} fast "
                f"workers, got {len(set(fast_workers))}"
            )
        code = self.Dbar[i]
        if self.construction == "frc" and self.tol.s_w > 0 and _frc_ok(
            self.topo.m[i], self.assignment.n_i(i), self.tol.s_w
        ):
            return frc_decode_weights(code, fast_workers)
        return code.full_decode_weights(fast_workers)

    def master_decode_weights(self, fast_edges: Sequence[int]) -> np.ndarray:
        """``a_F`` (len n, zero on stragglers) — eq. (26)."""
        if len(set(fast_edges)) < self.topo.n - self.tol.s_e:
            raise ValueError(
                f"need ≥ {self.topo.n - self.tol.s_e} fast edges, got "
                f"{len(set(fast_edges))}"
            )
        if self.construction == "frc" and self.tol.s_e > 0 and _frc_ok(
            self.topo.n, self.K, self.tol.s_e
        ):
            return frc_decode_weights(self.B, fast_edges)
        return self.B.full_decode_weights(fast_edges)

    def edge_decode(
        self,
        i: int,
        fast_workers: Sequence[int],
        messages: Dict[int, np.ndarray],
    ) -> np.ndarray:
        """``G_i`` from the fastest workers' messages — eq. (25)."""
        c = self.edge_decode_weights(i, fast_workers)
        out = None
        for j in fast_workers:
            term = c[j] * messages[j]
            out = term if out is None else out + term
        return out

    def master_decode(
        self, fast_edges: Sequence[int], edge_results: Dict[int, np.ndarray]
    ) -> np.ndarray:
        """Full gradient ``g`` from the fastest edges — eq. (27)."""
        a = self.master_decode_weights(fast_edges)
        out = None
        for i in fast_edges:
            term = a[i] * edge_results[i]
            out = term if out is None else out + term
        return out

    # ------------------------------------------------------------------
    # Collapsed per-worker weights for the distributed runtime
    # ------------------------------------------------------------------
    def collapsed_weights(
        self,
        fast_edges: Sequence[int],
        fast_workers: Sequence[Sequence[int]],
    ) -> np.ndarray:
        """λ_ij = a_i c^i_j for every worker, zero for stragglers.

        Returns a flat array over ``topo.worker_ids()`` order.  The
        decoded full gradient equals Σ_ij λ_ij G_ij.
        """
        a = self.master_decode_weights(fast_edges)
        lam = np.zeros(self.topo.total_workers, dtype=np.float64)
        for i in fast_edges:
            c = self.edge_decode_weights(i, fast_workers[i])
            for j in fast_workers[i]:
                lam[self.topo.flat_index(i, j)] = a[i] * c[j]
        return lam

    def encoding_matrix_flat(self) -> np.ndarray:
        """(Σ m_i) × K matrix of effective worker coefficients."""
        rows = []
        for i in range(self.topo.n):
            Di = self.D_expanded(i)
            for j in range(self.topo.m[i]):
                rows.append(Di[j] * self.B.matrix[i])
        return np.stack(rows, axis=0)

    # ------------------------------------------------------------------
    # End-to-end simulation (reference pipeline used by tests/benches)
    # ------------------------------------------------------------------
    def simulate_iteration(
        self,
        g_parts: np.ndarray,
        edge_stragglers: Sequence[int] = (),
        worker_stragglers: Optional[Sequence[Sequence[int]]] = None,
    ) -> np.ndarray:
        """Run encode → edge decode → master decode; returns decoded g.

        ``g_parts``: (K, dim) stacked per-part gradients.
        """
        if worker_stragglers is None:
            worker_stragglers = [()] * self.topo.n
        fast_edges = [
            i for i in range(self.topo.n) if i not in set(edge_stragglers)
        ][: self.topo.n - self.tol.s_e]
        edge_results: Dict[int, np.ndarray] = {}
        for i in fast_edges:
            dead = set(worker_stragglers[i])
            fast = [j for j in range(self.topo.m[i]) if j not in dead]
            fast = fast[: self.topo.m[i] - self.tol.s_w_of(i)]
            msgs = {j: self.worker_encode(i, j, g_parts) for j in fast}
            edge_results[i] = self.edge_decode(i, fast, msgs)
        return self.master_decode(fast_edges, edge_results)


def _frc_ok(rows: int, cols: int, s: int) -> bool:
    return rows % (s + 1) == 0 and cols % (rows // (s + 1)) == 0
