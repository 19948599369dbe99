"""Elastic tolerance/topology replanning + straggler detection.

Mid-run adaptation in three moves (consumed by ``launch.train``):

  * :class:`StragglerDetector` — EWMA of observed per-worker iteration
    totals (eq. 31 samples); persistent drift is folded back into the
    cluster model's deterministic compute term ``c``,
  * :func:`replan` — re-run JNCSS (Algorithm 2) on the updated model and
    rebuild the HGC code for the chosen tolerance.  A tolerance change
    costs one host-side code rebuild; the compiled train step is reused
    because λ enters as data (see :mod:`repro_torch.dist.grad_sync`),
  * :func:`shrink_topology` — drop PERMANENTLY failed edges/workers from
    the cluster description (transient stragglers need no action: the
    code tolerates them by construction).

The heterogeneity-aware replanning direction follows Wang et al.
(arXiv:1901.09339); HGC's two-layer structure makes it a pure
(s_e, s_w) grid search (paper Theorem 2).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import jncss as jncss_mod
from repro_torch.core import tradeoff
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import ClusterParams, kth_min
from repro_torch.core.topology import Tolerance, Topology


@dataclasses.dataclass(frozen=True)
class Plan:
    """A planning outcome: the deployed code + the planner diagnostics.

    Produced by :func:`replan` (JNCSS) or by any ``repro_torch.api.Planner``
    strategy; ``jncss`` is ``None`` for fixed/uniform strategies.  The
    plan is also the λ provider of the deployed code: :meth:`lam` /
    :meth:`lam_array` turn an observed straggler pattern into the
    runtime decode-weight operand the train step consumes.
    """

    code: HGCCode
    tol: Tolerance
    K: int
    expected_iteration_ms: float
    jncss: Optional[jncss_mod.JNCSSResult] = None

    @property
    def load(self) -> int:
        return self.code.load

    @property
    def deployed(self) -> dict:
        """The (tolerance, K) triple checkpoints persist."""
        return {"s_e": self.tol.s_e, "s_w": self.tol.s_w, "K": self.K}

    def lam(self, fast_edges, fast_workers) -> np.ndarray:
        """Collapsed flat per-worker decode weights λ_ij (stragglers 0)."""
        return self.code.collapsed_weights(fast_edges, fast_workers)

    def lam_array(self, fast_edges, fast_workers) -> np.ndarray:
        """λ_ij as the (pods, data) runtime operand of the dist step.

        Requires a uniform topology (every edge the same worker count) —
        exactly the shape the (pod, data) mesh can carry.
        """
        topo = self.code.topo
        if len(set(topo.m)) != 1:
            raise ValueError(
                f"lam_array needs a uniform topology, got m={topo.m}"
            )
        # the one implementation of the λ→mesh mapping (torch-importing
        # module, hence lazy — this module stays numpy-only)
        from repro_torch.dist.grad_sync import lam_array_from_code

        return lam_array_from_code(
            self.code, fast_edges, fast_workers, topo.n, topo.m[0]
        )


def price_tolerance(
    params: ClusterParams, tol: Tolerance, load: float
) -> float:
    """Expected iteration time T̂ (ms) of a tolerance at a deployed load.

    The JNCSS order-statistic expression (eq. 43 flavor) evaluated at
    the load ``D`` the built code actually carries — shared by
    :func:`replan` and the fixed-tolerance planner strategies so every
    ``Plan`` prices consistently.
    """
    scores, _ = jncss_mod._edge_scores(params, float(load), tol.s_w)
    return float(kth_min(scores, params.topo.n - tol.s_e))


def replan(
    params: ClusterParams,
    K: int,
    seed: int = 0,
    construction: str = "random",
    reuse: Optional[HGCCode] = None,
) -> Plan:
    """JNCSS-plan a tolerance for this cluster and build its HGC code.

    ``K`` is a target part count; it is bumped to the nearest
    construction-compatible value for the chosen (s_e, s_w) (divisibility
    of eqs. 15/18), so the returned ``plan.K`` may exceed the request.

    ``reuse``: the currently deployed code — when JNCSS lands on the
    same (tolerance, K, topology) the deployed code is returned as-is
    instead of being rebuilt, so part assignments (and therefore the
    caller's per-part data streams) stay valid with zero churn.
    """
    res = jncss_mod.solve(params, K)
    tol = Tolerance(res.s_e, res.s_w)
    K_c = tradeoff.compatible_K(params.topo, tol, at_least=K)
    if (
        reuse is not None
        and reuse.tol == tol
        and reuse.K == K_c
        and reuse.topo == params.topo
    ):
        code = reuse
    else:
        code = HGCCode.build(
            params.topo, tol, K=K_c, seed=seed, construction=construction
        )
    # res.T_tol was evaluated at the REQUESTED K's load; re-price the
    # order-statistic expression at the load the built code actually
    # carries (K_c ≥ K bumps D proportionally).
    T_deployed = price_tolerance(params, tol, code.load)
    return Plan(
        code=code,
        tol=tol,
        K=K_c,
        expected_iteration_ms=T_deployed,
        jncss=res,
    )


def shrink_topology(
    params: ClusterParams,
    dead_edges: Iterable[int] = (),
    dead_workers: Iterable[Tuple[int, int]] = (),
) -> ClusterParams:
    """Cluster model with permanently failed nodes removed.

    ``dead_workers`` are (edge, worker) pairs in the ORIGINAL indexing;
    workers under a dead edge are removed implicitly.  Model/optimizer
    state is topology-independent, so training resumes from the last
    checkpoint against the shrunk cluster.
    """
    dead_e = set(dead_edges)
    dead_w = set(tuple(p) for p in dead_workers)
    topo = params.topo
    keep_edges = [i for i in range(topo.n) if i not in dead_e]
    if not keep_edges:
        raise ValueError("all edges dead — nothing to shrink to")
    new_m = []
    keep_flat = []
    for i in keep_edges:
        kept = [j for j in range(topo.m[i]) if (i, j) not in dead_w]
        if not kept:
            raise ValueError(f"edge {i} has no surviving workers")
        new_m.append(len(kept))
        keep_flat.extend(topo.flat_index(i, j) for j in kept)
    idx = np.asarray(keep_flat, np.intp)
    eidx = np.asarray(keep_edges, np.intp)
    return ClusterParams(
        topo=Topology(m=tuple(new_m)),
        c=params.c[idx],
        gamma=params.gamma[idx],
        tau_w=params.tau_w[idx],
        p_w=params.p_w[idx],
        tau_e=params.tau_e[eidx],
        p_e=params.p_e[eidx],
        master_contention=params.master_contention,
    )


class StragglerDetector:
    """EWMA tracker of observed worker totals vs the cluster model.

    ``observe`` feeds one iteration's flat worker totals (eq. 31
    samples, as produced by ``ClusterParams.sample_iteration``);
    ``updated_params`` folds any persistent positive drift into the
    deterministic compute term ``c`` so the next JNCSS pass plans
    around nodes that *got* slow, not just nodes that *were* slow.
    """

    def __init__(self, params: ClusterParams, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.params = params
        self.alpha = float(alpha)
        self.ewma: Optional[np.ndarray] = None
        self.n_obs = 0

    def observe(self, worker_total: Sequence[float]) -> None:
        wt = np.asarray(worker_total, np.float64)
        if wt.shape != (self.params.topo.total_workers,):
            raise ValueError(
                f"expected ({self.params.topo.total_workers},) totals, "
                f"got {wt.shape}"
            )
        if self.ewma is None:
            self.ewma = wt.copy()
        else:
            self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * wt
        self.n_obs += 1

    def drift(self, D_ref: float) -> np.ndarray:
        """Observed-minus-expected per-worker total (0 before data)."""
        if self.ewma is None:
            return np.zeros(self.params.topo.total_workers)
        return self.ewma - self.params.expected_worker_total(D_ref)

    def persistent_stragglers(
        self, D_ref: float, factor: float = 2.0
    ) -> np.ndarray:
        """Flat indices whose EWMA exceeds ``factor ×`` the model mean."""
        if self.ewma is None:
            return np.empty(0, np.intp)
        base = self.params.expected_worker_total(D_ref)
        return np.flatnonzero(self.ewma > factor * base)

    def state_dict(self) -> dict:
        """JSON-serializable snapshot (checkpoint ``extra`` payload).

        A restored run replans from *observed* delays instead of priors;
        floats survive the JSON round trip exactly (repr round-trip), so
        kill/resume replans bit-for-bit.
        """
        return {
            "alpha": self.alpha,
            "n_obs": self.n_obs,
            "ewma": None if self.ewma is None else self.ewma.tolist(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.alpha = float(d["alpha"])
        self.n_obs = int(d["n_obs"])
        ewma = d.get("ewma")
        self.ewma = (
            None if ewma is None else np.asarray(ewma, np.float64).copy()
        )

    def updated_params(self, D_ref: float) -> ClusterParams:
        """Cluster model with positive drift folded into ``c``.

        Only slowdowns are applied (speedups are usually measurement
        luck); drift divides by ``D_ref`` because ``c`` is per-part.
        """
        extra = np.maximum(self.drift(D_ref), 0.0) / max(D_ref, 1e-12)
        return dataclasses.replace(self.params, c=self.params.c + extra)
