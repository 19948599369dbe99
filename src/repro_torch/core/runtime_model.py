"""Per-iteration runtime model — paper §IV-A.

Worker (i,j):
  compute   T_cmp = c_{(i,j)} · D + Exp(γ_{(i,j)})          (eq 28, shifted exp)
  comm      T_com = N · τ_{(i,j)},  N ~ Geom(1−p_{(i,j)})   (eqs 29/30;
            Pr(N=x) = p^{x−1}(1−p), retransmissions on an unreliable link)
  total     T^{(i,j)} = T^i_dl + T^{(i,j)}_dl + T_cmp + T^{(i,j)}_ul  (eq 31)

Edge i:     T^i = T^i_ul + min_{(m_i−s_w)-th} T^{(i,j)}              (eq 32)
System:     T   = min_{(n−s_e)-th} T^i                               (eq 33)

Everything is vectorized numpy (flat worker arrays with an edge index),
so the simulator can run thousands of iterations × schemes quickly and
JNCSS can evaluate big topologies (1000+ node scaling).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.topology import Topology


def kth_min(values: np.ndarray, k: int, axis: int = -1) -> np.ndarray:
    """The paper's ``min_{k-th}``: k-th smallest (1-indexed)."""
    if k < 1:
        raise ValueError("k is 1-indexed and must be ≥ 1")
    return np.partition(values, k - 1, axis=axis).take(k - 1, axis=axis)


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Heterogeneous cluster description (flat worker arrays).

    Worker arrays have length ``topo.total_workers`` in
    ``topo.worker_ids()`` order; edge arrays have length ``topo.n``.
    Units follow the paper: milliseconds, rates in 1/ms.
    """

    topo: Topology
    c: np.ndarray        # per-part deterministic compute time (ms)
    gamma: np.ndarray    # exponential rate of stochastic compute (1/ms)
    tau_w: np.ndarray    # worker↔edge single-transmission time (ms)
    p_w: np.ndarray      # worker link failure probability
    tau_e: np.ndarray    # edge↔master single-transmission time (ms)
    p_e: np.ndarray      # edge link failure probability
    # Fan-in contention at the master for the DIRECT worker↔master path
    # (Standard GC): the master is one endpoint serving Σm_i uploads
    # where an edge serves m_i — slowdown ≈ n (paper §I's "severe
    # bottleneck at the master").  0 ⇒ defaults to topo.n.
    master_contention: float = 0.0

    def __post_init__(self):
        W, n = self.topo.total_workers, self.topo.n
        for name, arr, size in [
            ("c", self.c, W),
            ("gamma", self.gamma, W),
            ("tau_w", self.tau_w, W),
            ("p_w", self.p_w, W),
            ("tau_e", self.tau_e, n),
            ("p_e", self.p_e, n),
        ]:
            if np.asarray(arr).shape != (size,):
                raise ValueError(f"{name} must have shape ({size},)")

    # ------------------------------------------------------------------
    @property
    def edge_of(self) -> np.ndarray:
        """Edge index of every flat worker."""
        return np.repeat(np.arange(self.topo.n), np.array(self.topo.m))

    # -------------------- expectations (used by JNCSS) -----------------
    def expected_worker_total(self, D: float) -> np.ndarray:
        """B_{(i,j)} of Algorithm 2 (eq 43 expectation), flat array."""
        e = self.edge_of
        return (
            self.c * D
            + 1.0 / self.gamma
            + 2.0 * self.tau_w / (1.0 - self.p_w)
            + (self.tau_e / (1.0 - self.p_e))[e]
        )

    def expected_edge_upload(self) -> np.ndarray:
        """A_i of Algorithm 2: τ_i/(1−p_i)."""
        return self.tau_e / (1.0 - self.p_e)

    def worker_total_variance(self, D: float = 0.0) -> np.ndarray:
        """Var[T^{(i,j)}] (D enters only the deterministic shift ⇒ unused).

        Var = 1/γ² + 2 τ_w² p_w/(1−p_w)² + τ_e² p_e/(1−p_e)² (independent
        exponential + two geometric links + the edge download hop).
        """
        e = self.edge_of
        var_geo_w = self.tau_w**2 * self.p_w / (1.0 - self.p_w) ** 2
        var_geo_e = (self.tau_e**2 * self.p_e / (1.0 - self.p_e) ** 2)[e]
        return 1.0 / self.gamma**2 + 2.0 * var_geo_w + var_geo_e

    # ----------------------------- sampling ----------------------------
    def sample_iteration(
        self, rng: np.random.Generator, D: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One iteration's random times.

        Returns:
          worker_total: flat (W,) — eq (31) totals (incl. edge download),
          edge_upload:  (n,)     — T^i_com,u samples,
          worker_direct:(W,)     — worker↔master totals for Standard GC
                                   (no edge hop: 2 worker-link transfers).
        """
        W = self.topo.total_workers
        t_cmp = self.c * D + rng.exponential(1.0 / self.gamma, size=W)
        # np.Generator.geometric(q) has P(k)=(1−q)^{k−1} q, k≥1 — the
        # paper's distribution with q = 1−p.
        n_dl = rng.geometric(1.0 - self.p_w, size=W)
        n_ul = rng.geometric(1.0 - self.p_w, size=W)
        t_w_comm = (n_dl + n_ul) * self.tau_w
        n_e_dl = rng.geometric(1.0 - self.p_e, size=self.topo.n)
        n_e_ul = rng.geometric(1.0 - self.p_e, size=self.topo.n)
        edge_dl = (n_e_dl * self.tau_e)[self.edge_of]
        worker_total = edge_dl + t_w_comm + t_cmp
        edge_upload = n_e_ul * self.tau_e
        contention = self.master_contention or float(self.topo.n)
        worker_direct = t_w_comm * contention + t_cmp
        return worker_total, edge_upload, worker_direct

    # --------------------------- constructors --------------------------
    @staticmethod
    def homogeneous(
        topo: Topology,
        c: float,
        gamma: float,
        tau_w: float,
        p_w: float,
        tau_e: float,
        p_e: float,
    ) -> "ClusterParams":
        W, n = topo.total_workers, topo.n
        return ClusterParams(
            topo=topo,
            c=np.full(W, c),
            gamma=np.full(W, gamma),
            tau_w=np.full(W, tau_w),
            p_w=np.full(W, p_w),
            tau_e=np.full(n, tau_e),
            p_e=np.full(n, p_e),
        )


def paper_cluster(dataset: str = "mnist") -> ClusterParams:
    """The exact simulation setting of paper §V-A.

    1 master, n=4 edges × m=10 workers.
    Edges:   Type I  ×1: p=0.1, τ=50ms
             Type II ×2: p=0.1, τ=100ms
             Type III×1: p=0.2, τ=500ms
    Workers (per edge): Type I ×5: p=.1, τ=50,  γ=.1
                        Type II ×2: p=.5, τ=100, γ=.1
                        Type III×2: p=.1, τ=50,  γ=.01
                        Type IV ×1: p=.5, τ=100, γ=.01
    c: strong compute 10ms (MNIST) / 100ms (CIFAR); weak 5×.
    "Strong computation" = Types I & II (γ=0.1).
    """
    topo = Topology.uniform(4, 10)
    tau_e = np.array([50.0, 100.0, 100.0, 500.0])
    p_e = np.array([0.1, 0.1, 0.1, 0.2])
    # per-edge worker pattern
    tau_w_edge = [50.0] * 5 + [100.0] * 2 + [50.0] * 2 + [100.0]
    p_w_edge = [0.1] * 5 + [0.5] * 2 + [0.1] * 2 + [0.5]
    gamma_edge = [0.1] * 5 + [0.1] * 2 + [0.01] * 2 + [0.01]
    strong_c = 10.0 if dataset == "mnist" else 100.0
    weak_c = 5.0 * strong_c
    c_edge = [strong_c if g == 0.1 else weak_c for g in gamma_edge]
    n = topo.n
    return ClusterParams(
        topo=topo,
        c=np.array(c_edge * n),
        gamma=np.array(gamma_edge * n),
        tau_w=np.array(tau_w_edge * n),
        p_w=np.array(p_w_edge * n),
        tau_e=tau_e,
        p_e=p_e,
    )


def expected_max_exponential(gamma: float, k: int) -> float:
    """E[max of k iid Exp(γ)] ≈ ln(k)/γ (paper's approximation, §IV-B)."""
    if k <= 0:
        raise ValueError("k must be positive")
    return np.log(max(k, 1)) / gamma if k > 1 else 1.0 / gamma


def expected_max_geometric(p: float, k: int) -> float:
    """E[max of k iid Geom(1−p)] ≈ 1/2 − ln(k)/ln(p) (Eisenberg [20])."""
    if k <= 1:
        return 1.0 / (1.0 - p)
    return 0.5 - np.log(k) / np.log(p)
