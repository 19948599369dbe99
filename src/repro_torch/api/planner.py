"""Pluggable planning strategies: cluster model → deployed ``Plan``.

The seam the ROADMAP's scenario family plugs into: a ``Planner`` turns
a :class:`~repro_torch.core.runtime_model.ClusterParams` into a
:class:`~repro_torch.dist.elastic.Plan` (tolerance + built HGC code + λ
provider).  Three built-ins:

  * ``jncss``   — the paper's Algorithm 2 grid search (adaptive: the
    session re-invokes it on detector-updated params at replan time),
  * ``fixed``   — a pinned (s_e, s_w) tolerance,
  * ``uniform`` — uncoded baseline, tolerance (0, 0).

Two further strategies implement the families the module docstring of
:mod:`repro_torch.core.grouping` / :mod:`repro_torch.core.comm_tradeoff` describe:

  * ``grouped``     — heterogeneity-aware per-edge worker tolerances
    (Wang et al. 1901.09339 flavor): never slower than JNCSS in the
    model, strictly faster on intra-edge-heterogeneous clusters,
  * ``comm_budget`` — communication-budgeted tolerance selection
    (Gholami et al. 2502.18251 flavor): the cheapest exact code whose
    per-iteration message counts fit the given master/edge budgets.

Any other strategy drops in the same way: implement ``plan()`` and hand
the instance to ``CodedSession(planner=...)`` — no driver fork required.
See ``docs/planners.md`` for the selection guide.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

from repro_torch.core import tradeoff
from repro_torch.core.comm_tradeoff import solve_comm_budget
from repro_torch.core.grouping import (
    GroupedHGCCode,
    GroupTolerance,
    compatible_K_grouped,
    plan_grouped,
    price_grouped,
)
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import ClusterParams
from repro_torch.core.topology import Tolerance, Topology
from repro_torch.dist.elastic import Plan, price_tolerance, replan


@runtime_checkable
class Planner(Protocol):
    """Strategy protocol: price tolerances, build the deployed code."""

    def initial_K(self, topo: Topology) -> int:
        """Target part count before construction-compatibility bumping."""
        ...

    def plan(self, params: ClusterParams, K: int, *, seed: int = 0,
             reuse: Optional[HGCCode] = None) -> Plan:
        """Plan a tolerance for ``params`` and build/reuse its code.

        ``reuse`` is the currently deployed code: when the strategy
        lands on the same (tolerance, K, topology) it MUST be returned
        as-is (identity, not equality) so the caller's part streams and
        compiled step stay valid with zero churn.
        """
        ...


@dataclasses.dataclass(frozen=True)
class JNCSSPlanner:
    """The paper's Algorithm 2: expected-iteration-time grid search.

    ``s_e_hint``/``s_w_hint`` only size the initial K request (the
    search itself picks the tolerance).
    """

    s_e_hint: int = 1
    s_w_hint: int = 1
    construction: str = "random"

    def initial_K(self, topo: Topology) -> int:
        return tradeoff.compatible_K(
            topo, Tolerance(self.s_e_hint, self.s_w_hint),
            at_least=topo.total_workers,
        )

    def plan(self, params: ClusterParams, K: int, *, seed: int = 0,
             reuse: Optional[HGCCode] = None) -> Plan:
        return replan(params, K, seed=seed,
                      construction=self.construction, reuse=reuse)


@dataclasses.dataclass(frozen=True)
class FixedPlanner:
    """A pinned tolerance: deploy (s_e, s_w) regardless of the cluster.

    The tolerance is clamped to what the topology can carry (at least
    one surviving edge / worker per edge) — a fixed-tolerance run that
    shrinks past a permanent failure keeps planning instead of dying.
    """

    s_e: int = 1
    s_w: int = 1
    construction: str = "random"

    @property
    def tol(self) -> Tolerance:
        return Tolerance(self.s_e, self.s_w)

    def _clamped(self, topo: Topology) -> Tolerance:
        return Tolerance(
            max(min(self.s_e, topo.n - 1), 0),
            max(min(self.s_w, min(topo.m) - 1), 0),
        )

    def initial_K(self, topo: Topology) -> int:
        return tradeoff.compatible_K(
            topo, self._clamped(topo), at_least=topo.total_workers
        )

    def plan(self, params: ClusterParams, K: int, *, seed: int = 0,
             reuse: Optional[HGCCode] = None) -> Plan:
        tol = self._clamped(params.topo)
        K_c = tradeoff.compatible_K(params.topo, tol, at_least=K)
        if (reuse is not None and reuse.tol == tol and reuse.K == K_c
                and reuse.topo == params.topo):
            code = reuse
        else:
            code = HGCCode.build(params.topo, tol, K=K_c, seed=seed,
                                 construction=self.construction)
        return Plan(
            code=code, tol=tol, K=K_c,
            expected_iteration_ms=price_tolerance(params, tol, code.load),
            jncss=None,
        )


@dataclasses.dataclass(frozen=True)
class UniformPlanner(FixedPlanner):
    """Uncoded baseline: no redundancy, wait for everyone."""

    s_e: int = 0
    s_w: int = 0


@dataclasses.dataclass(frozen=True)
class GroupedPlanner:
    """Heterogeneity-aware grouping: per-edge worker tolerances.

    Runs :func:`repro_torch.core.grouping.plan_grouped` — JNCSS's outer s_e
    grid with a decoupled per-edge argmin over each edge's own s_w^i —
    and deploys a :class:`~repro_torch.core.grouping.GroupedHGCCode`.  The
    uniform vector is always a candidate, so the model-expected time is
    never worse than JNCSS's; it is strictly better when worker speeds
    differ *within* edges.

    Caveat: non-uniform per-edge loads are incompatible with the
    ``--dist`` modes' even batch sharding — the session rejects such
    plans there (single-host mode and the simulator take them fine).
    """

    s_e_hint: int = 1
    s_w_hint: int = 1
    construction: str = "random"  # read by session resume; random only

    def initial_K(self, topo: Topology) -> int:
        return tradeoff.compatible_K(
            topo, Tolerance(self.s_e_hint, self.s_w_hint),
            at_least=topo.total_workers,
        )

    def plan(self, params: ClusterParams, K: int, *, seed: int = 0,
             reuse: Optional[HGCCode] = None) -> Plan:
        res = plan_grouped(params, K)
        gtol = GroupTolerance(res.s_e, res.s_w_vec)
        K_c = compatible_K_grouped(params.topo, gtol, at_least=K)
        if (reuse is not None and reuse.tol == gtol and reuse.K == K_c
                and reuse.topo == params.topo):
            code = reuse
        else:
            code = GroupedHGCCode.build(
                params.topo, gtol, K=K_c, seed=seed
            )
        return Plan(
            code=code, tol=gtol, K=K_c,
            expected_iteration_ms=price_grouped(params, gtol, code.loads),
            jncss=None,
        )


@dataclasses.dataclass(frozen=True)
class CommBudgetPlanner:
    """Communication-budgeted planning: cheapest code that fits the
    per-iteration message budgets.

    Budgets resolve per topology: ``max_master_msgs`` /
    ``max_edge_msgs`` pin them absolutely, otherwise ``master_shave`` /
    ``edge_shave`` subtract from the uncoded counts (``n`` master
    messages, ``max_i m_i`` at the busiest edge).  Tightening a budget
    forces tolerance — and with it per-worker compute — up: the
    communication↔computation trade-off.
    """

    max_master_msgs: Optional[int] = None
    max_edge_msgs: Optional[int] = None
    master_shave: int = 1
    edge_shave: int = 0
    construction: str = "random"

    def _budgets(self, topo: Topology):
        master = self.max_master_msgs
        if master is None:
            master = max(1, topo.n - self.master_shave)
        edge = self.max_edge_msgs
        if edge is None:
            edge = max(1, max(topo.m) - self.edge_shave)
        return master, edge

    def initial_K(self, topo: Topology) -> int:
        # size the K request at the loosest-tolerance corner; plan()
        # re-bumps for the tolerance the budget actually forces
        return tradeoff.compatible_K(
            topo, Tolerance(0, 0), at_least=topo.total_workers
        )

    def plan(self, params: ClusterParams, K: int, *, seed: int = 0,
             reuse: Optional[HGCCode] = None) -> Plan:
        master, edge = self._budgets(params.topo)
        point = solve_comm_budget(
            params, K, max_master_msgs=master, max_edge_msgs=edge
        )
        tol = point.tol
        K_c = tradeoff.compatible_K(params.topo, tol, at_least=K)
        if (reuse is not None and reuse.tol == tol and reuse.K == K_c
                and reuse.topo == params.topo):
            code = reuse
        else:
            code = HGCCode.build(params.topo, tol, K=K_c, seed=seed,
                                 construction=self.construction)
        return Plan(
            code=code, tol=tol, K=K_c,
            expected_iteration_ms=price_tolerance(params, tol, code.load),
            jncss=None,
        )


def get_planner(spec, s_e: int = 1, s_w: int = 1) -> Planner:
    """Resolve a planner: an instance passes through; a string picks a
    built-in strategy (``"jncss"`` | ``"fixed"`` | ``"uniform"`` |
    ``"grouped"`` | ``"comm_budget"``)."""
    if isinstance(spec, str):
        if spec == "jncss":
            return JNCSSPlanner(s_e_hint=s_e, s_w_hint=s_w)
        if spec == "fixed":
            return FixedPlanner(s_e, s_w)
        if spec == "uniform":
            return UniformPlanner()
        if spec == "grouped":
            return GroupedPlanner(s_e_hint=s_e, s_w_hint=s_w)
        if spec == "comm_budget":
            return CommBudgetPlanner(master_shave=s_e, edge_shave=s_w)
        raise ValueError(
            f"unknown planner {spec!r} (expected jncss | fixed | uniform "
            f"| grouped | comm_budget or a Planner instance)"
        )
    if not isinstance(spec, Planner):
        raise TypeError(f"not a Planner: {spec!r}")
    return spec


def planner_for_scheme(scheme: str, s_e: int = 1, s_w: int = 1) -> Planner:
    """The train CLI's ``--scheme`` names → planner strategies."""
    return get_planner(
        {
            "hgc_jncss": "jncss",
            "hgc": "fixed",
            "uncoded": "uniform",
            "hgc_grouped": "grouped",
            "hgc_comm": "comm_budget",
        }.get(scheme, scheme),
        s_e, s_w,
    )
