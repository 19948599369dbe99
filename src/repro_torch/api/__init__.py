"""`repro_torch.api` — the public object model of the port.

  * :class:`CodedCluster` — topology + runtime model + straggler detector,
  * the :class:`Planner` strategies and :func:`planner_for_scheme`,
  * :class:`CodedSession` — coded training on one device.

``repro_torch.api.serving`` (prefill/decode) is a submodule, not pulled
in here.
"""
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
    "CodedCluster",
    "CodedSession",
    "ReplanError",
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
]
