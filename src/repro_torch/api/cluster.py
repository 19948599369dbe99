"""`CodedCluster` — the hierarchical cluster as one public object.

The paper's system is a tree: one master, ``n`` edge nodes, ``m_i``
workers per edge, each with a runtime model (compute rate, link delay,
loss probability).  The repo's low-level pieces (``Topology``,
``ClusterParams``, ``StragglerDetector``, ``shrink_topology``) describe
it; this class OWNS it — construction (homogeneous / heterogeneous /
bootstrapped from observed delays), online observation, drift folding,
permanent-failure shrinking, and the straggler-pattern sampler the
training loop draws from each iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.runtime_model import ClusterParams
from repro_torch.core.topology import Topology
from repro_torch.dist.elastic import StragglerDetector, shrink_topology


def sample_straggler_pattern(rng, code, params: ClusterParams, D: float):
    """Sample runtimes, wait per the HGC rule, return the fast sets.

    Returns ``(fast_e, fast_w, T_iter_ms, worker_totals)``: the
    ``n − s_e`` fastest edges, per-edge the ``m_i − s_w`` fastest
    workers, the iteration time (slowest counted edge), and the flat
    eq.-(31) worker totals for detector feeding.
    """
    wt, eu, _ = params.sample_iteration(rng, D)
    topo = code.topo
    s_e = code.tol.s_e
    edge_T = np.empty(topo.n)
    fast_w = []
    off = 0
    for i in range(topo.n):
        mi = topo.m[i]
        # per-edge tolerance: uniform codes return s_w everywhere,
        # grouped codes their own s_w^i
        order = np.argsort(wt[off : off + mi])[: mi - code.tol.s_w_of(i)]
        edge_T[i] = eu[i] + wt[off + order[-1]]
        fast_w.append(tuple(sorted(order.tolist())))
        off += mi
    eorder = np.argsort(edge_T)[: topo.n - s_e]
    fast_e = tuple(sorted(eorder.tolist()))
    return fast_e, fast_w, float(edge_T[eorder[-1]]), wt


class CodedCluster:
    """Topology + runtime model + straggler detector, as one object.

    ``params`` is the CURRENT cluster (post-shrink); ``base_params``
    plus the accumulated ``dead_edges``/``dead_workers`` (in ORIGINAL
    indexing) reconstruct it deterministically — that is what a
    checkpoint persists, so a resumed run rebuilds the exact surviving
    cluster before replaying the straggler-pattern stream.
    """

    def __init__(self, params: ClusterParams, *, alpha: float = 0.3,
                 base_params: Optional[ClusterParams] = None,
                 dead_edges: Tuple[int, ...] = (),
                 dead_workers: Tuple[Tuple[int, int], ...] = ()):
        self.params = params
        self.base_params = base_params if base_params is not None else params
        self.dead_edges = tuple(dead_edges)
        self.dead_workers = tuple(tuple(p) for p in dead_workers)
        self.alpha = float(alpha)
        self.detector = StragglerDetector(params, alpha=alpha)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def homogeneous(
        cls, n_edges: int = 2, n_workers: int = 4, *,
        topo: Optional[Topology] = None,
        c: float = 10.0, gamma: float = 0.05, tau_w: float = 50.0,
        p_w: float = 0.2, tau_e: float = 100.0, p_e: float = 0.1,
        alpha: float = 0.3,
    ) -> "CodedCluster":
        """Every node identical.  Coding rarely pays off here: JNCSS
        correctly picks (0, 0) because tolerating an edge only raises
        the load."""
        topo = topo or Topology.uniform(n_edges, n_workers)
        return cls(
            ClusterParams.homogeneous(
                topo, c=c, gamma=gamma, tau_w=tau_w, p_w=p_w,
                tau_e=tau_e, p_e=p_e,
            ),
            alpha=alpha,
        )

    @classmethod
    def hetero(
        cls, n_edges: int = 2, n_workers: int = 4, *,
        topo: Optional[Topology] = None,
        slow_edge: int = -1, slow_tau_e: float = 2000.0,
        slow_p_e: float = 0.4, alpha: float = 0.3, **base_knobs,
    ) -> "CodedCluster":
        """One Type-III-style straggler edge (slow, loss-prone uplink,
        paper §V-A flavor): the regime where JNCSS actually buys edge
        tolerance (s_e ≥ 1)."""
        base = cls.homogeneous(n_edges, n_workers, topo=topo,
                               alpha=alpha, **base_knobs)
        tau_e = base.params.tau_e.copy()
        p_e = base.params.p_e.copy()
        tau_e[slow_edge] = slow_tau_e
        p_e[slow_edge] = slow_p_e
        return cls(
            dataclasses.replace(base.params, tau_e=tau_e, p_e=p_e),
            alpha=alpha,
        )

    @classmethod
    def from_observations(
        cls, topo: Topology, worker_totals: Sequence[Sequence[float]],
        D: float, *, gamma: float = 0.05, tau_w: float = 50.0,
        p_w: float = 0.2, tau_e: float = 100.0, p_e: float = 0.1,
        alpha: float = 0.3,
    ) -> "CodedCluster":
        """Bootstrap a cluster model from observed per-worker totals.

        ``worker_totals`` is an (iterations × total_workers) record of
        eq.-(31) samples at load ``D``; the per-part compute term ``c``
        is fitted so the model's expected totals match the observed
        means (link terms at the provided priors), and the detector is
        warm-started with the observations — the first JNCSS pass then
        plans from measured delays, not priors.
        """
        obs = np.asarray(worker_totals, np.float64)
        if obs.ndim != 2 or obs.shape[1] != topo.total_workers:
            raise ValueError(
                f"worker_totals must be (iters, {topo.total_workers}), "
                f"got {obs.shape}"
            )
        base = ClusterParams.homogeneous(
            topo, c=1.0, gamma=gamma, tau_w=tau_w, p_w=p_w,
            tau_e=tau_e, p_e=p_e,
        )
        # E[total] = c·D + 1/γ + link terms  ⇒  c = (mean − rest)/D
        rest = base.expected_worker_total(D) - base.c * D
        c = np.maximum((obs.mean(axis=0) - rest) / max(D, 1e-12), 1e-6)
        cluster = cls(dataclasses.replace(base, c=c), alpha=alpha)
        for row in obs:
            cluster.observe(row)
        return cluster

    # ------------------------------------------------------------------
    @property
    def topo(self) -> Topology:
        return self.params.topo

    def observe(self, worker_totals: Sequence[float]) -> None:
        """Feed one iteration's flat worker totals to the detector."""
        self.detector.observe(worker_totals)

    def updated_params(self, D_ref: float) -> ClusterParams:
        """Cluster model with observed positive drift folded into ``c``
        (what a replan should price)."""
        return self.detector.updated_params(D_ref)

    def sample_pattern(self, rng, code, D=None):
        """One iteration's straggler pattern under the deployed code.

        ``D`` defaults to the code's per-worker load — the flat array
        for grouped codes (edges may carry different loads), the scalar
        otherwise.
        """
        if D is None:
            D = getattr(code, "load_array", code.load)
        return sample_straggler_pattern(rng, code, self.params, D)

    # ------------------------------------------------------------------
    # permanent failures
    # ------------------------------------------------------------------
    def shrink(
        self,
        dead_edges: Iterable[int] = (),
        dead_workers: Iterable[Tuple[int, int]] = (),
    ) -> "CodedCluster":
        """Cluster with permanently failed nodes removed (fresh detector).

        Indices are in the CURRENT cluster's numbering; the returned
        cluster's ``dead_edges``/``dead_workers`` are re-expressed in
        ORIGINAL (base) numbering so the failure record composes across
        repeated shrinks and survives checkpointing.
        """
        dead_e = sorted(set(dead_edges))
        dead_w = sorted(set(tuple(p) for p in dead_workers))
        # current → original numbering, for edges AND workers (a prior
        # worker shrink re-indexes the survivors within its edge)
        prior_w = set(self.dead_workers)
        alive = [i for i in range(self.base_params.topo.n)
                 if i not in self.dead_edges]
        orig_dead_e = self.dead_edges + tuple(alive[i] for i in dead_e)

        def orig_worker(i, j):
            I = alive[i]
            alive_ws = [J for J in range(self.base_params.topo.m[I])
                        if (I, J) not in prior_w]
            return I, alive_ws[j]

        orig_dead_w = self.dead_workers + tuple(
            orig_worker(i, j) for (i, j) in dead_w
        )
        new_params = shrink_topology(
            self.base_params, dead_edges=orig_dead_e,
            dead_workers=orig_dead_w,
        )
        return CodedCluster(
            new_params, alpha=self.alpha, base_params=self.base_params,
            dead_edges=orig_dead_e, dead_workers=orig_dead_w,
        )

    # ------------------------------------------------------------------
    # persistence (checkpoint ``extra`` payload)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "dead_edges": list(self.dead_edges),
            "dead_workers": [list(p) for p in self.dead_workers],
            "detector": self.detector.state_dict(),
        }

    def restored(self, d: Dict) -> "CodedCluster":
        """Cluster rebuilt from a checkpoint snapshot (same base)."""
        cluster = CodedCluster(
            shrink_topology(
                self.base_params,
                dead_edges=d.get("dead_edges", ()),
                dead_workers=[tuple(p) for p in d.get("dead_workers", ())],
            ) if (d.get("dead_edges") or d.get("dead_workers"))
            else self.base_params,
            alpha=self.alpha,
            base_params=self.base_params,
            dead_edges=tuple(d.get("dead_edges", ())),
            dead_workers=tuple(tuple(p) for p in d.get("dead_workers", ())),
        )
        if "detector" in d:
            cluster.detector.load_state_dict(d["detector"])
        return cluster

    def __repr__(self) -> str:
        return (f"CodedCluster(m={self.topo.m}, "
                f"dead_edges={list(self.dead_edges)}, "
                f"observations={self.detector.n_obs})")
