"""Orchestrator of the port — the coded training loop as a supervised
service (the numpy-only copy of ``repro.orchestrator``).

Public surface::

    from repro_torch.orchestrator import (
        DeviceRegistry, HeartbeatMonitor, HeartbeatConfig,
        InjectionSchedule, FailureInjector, WorkerPool,
        Orchestrator, OrchestratorConfig, MetricsSink, read_metrics,
        EventLog,
    )

Imports here are LAZY on purpose: spawned worker processes import
``repro_torch.orchestrator.workers`` (numpy-only) through this package,
and must never pay for the controller's torch import.
"""
from __future__ import annotations

_EXPORTS = {
    "Event": "repro_torch.orchestrator.events",
    "EventLog": "repro_torch.orchestrator.events",
    "DeviceRegistry": "repro_torch.orchestrator.registry",
    "WorkerRecord": "repro_torch.orchestrator.registry",
    "Heartbeat": "repro_torch.orchestrator.heartbeat",
    "HeartbeatConfig": "repro_torch.orchestrator.heartbeat",
    "HeartbeatMonitor": "repro_torch.orchestrator.heartbeat",
    "Injection": "repro_torch.orchestrator.injector",
    "InjectionSchedule": "repro_torch.orchestrator.injector",
    "FailureInjector": "repro_torch.orchestrator.injector",
    "RoundEffects": "repro_torch.orchestrator.injector",
    "ModelRow": "repro_torch.orchestrator.workers",
    "WorkItem": "repro_torch.orchestrator.workers",
    "WorkerPool": "repro_torch.orchestrator.workers",
    "rows_from_params": "repro_torch.orchestrator.workers",
    "MetricsSink": "repro_torch.orchestrator.metrics",
    "read_metrics": "repro_torch.orchestrator.metrics",
    "METRICS_SCHEMA_VERSION": "repro_torch.orchestrator.metrics",
    "Orchestrator": "repro_torch.orchestrator.controller",
    "OrchestratorConfig": "repro_torch.orchestrator.controller",
    "derive_heartbeat": "repro_torch.orchestrator.controller",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name])
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
