"""`repro_torch.api` — the public object model of the port.

  * :class:`CodedCluster` — topology + runtime model + straggler detector,
  * the :class:`Planner` strategies and :func:`planner_for_scheme`,
  * :class:`CodedSession` — coded training on one device, checkpoints
    and kill/resume, shrink, eval and generate,
  * re-exports of the stable core/dist/sim vocabulary (``Topology``,
    ``HGCCode``, ``replan``, ``simulate_training``, …), as the
    reference's ``repro.api`` has them.

``repro_torch.api.serving`` (prefill/decode) is a submodule, not pulled
in here.
"""
from repro_torch.core import jncss, tradeoff
from repro_torch.core.grouping import GroupedHGCCode, GroupTolerance
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import ClusterParams, paper_cluster
from repro_torch.core.topology import Tolerance, Topology
from repro_torch.dist.elastic import (
    Plan,
    StragglerDetector,
    price_tolerance,
    replan,
    shrink_topology,
)
from repro_torch.sim.simulator import simulate_training

from repro_torch.api.cluster import CodedCluster, sample_straggler_pattern
from repro_torch.api.planner import (
    CommBudgetPlanner,
    FixedPlanner,
    GroupedPlanner,
    JNCSSPlanner,
    Planner,
    UniformPlanner,
    get_planner,
    planner_for_scheme,
)
from repro_torch.api.session import CodedSession, ReplanError, build_coded_batch

__all__ = [
    # the object model
    "CodedCluster",
    "CodedSession",
    "ReplanError",
    "Plan",
    "Planner",
    "JNCSSPlanner",
    "FixedPlanner",
    "UniformPlanner",
    "GroupedPlanner",
    "CommBudgetPlanner",
    "get_planner",
    "planner_for_scheme",
    "build_coded_batch",
    "sample_straggler_pattern",
    # stable re-exported vocabulary
    "Topology",
    "Tolerance",
    "GroupTolerance",
    "HGCCode",
    "GroupedHGCCode",
    "ClusterParams",
    "paper_cluster",
    "StragglerDetector",
    "replan",
    "shrink_topology",
    "price_tolerance",
    "simulate_training",
    "jncss",
    "tradeoff",
]
