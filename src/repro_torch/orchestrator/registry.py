"""Device registry — worker/edge identity, capability, liveness.

The paper's cluster is a static tree; a real deployment is not.  The
registry is the control plane's single source of truth about *who is
currently in the tree*: every worker has an identity (its (edge,
worker) slot and flat index), a capability record (the per-part compute
rate it advertised at join), and a liveness state driven by heartbeats:

    JOINING ──beat──► HEALTHY ──deadline miss──► SUSPECT ──more──► DEAD
       │                 ▲                        ▲ │                │
       └─ join grace ────┼─── expires (miss) ─────┘ │                │
                         └────────── beat ──────────┘                │
                         └───────────────── beat (heal) ─────────────┘

``SUSPECT -> HEALTHY`` is a recovery (a flap: the worker missed a
deadline but beat again inside the death budget); ``DEAD -> HEALTHY``
is a rejoin (a healed partition — the *process* may be fine even though
liveness declared it gone).  A worker that never delivers its FIRST
beat takes the ``JOINING -> SUSPECT -> DEAD`` path once the (wider)
join grace deadline expires — a worker killed before it ever reported
must still be detectable.  All transitions emit :mod:`events` so the
controller can translate them into replans; the registry itself never
touches the session.

Edge (pod) liveness is derived: an edge is down when none of its
workers are HEALTHY/JOINING — the registry emits ``edge_down`` /
``edge_up`` on the boundary crossings so a pod-level failure is one
event, not ``m_i`` separate ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.topology import Topology
from repro_torch.orchestrator import events as ev

# liveness states (stable strings — part of the metrics schema)
JOINING = "JOINING"
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"
STATES = (JOINING, HEALTHY, SUSPECT, DEAD)

# legal transitions of the liveness machine; anything else is a bug in
# the caller and raises instead of silently corrupting the registry
_TRANSITIONS = {
    (JOINING, HEALTHY),
    (JOINING, SUSPECT),   # join grace expired without a first beat
    (HEALTHY, SUSPECT),
    (SUSPECT, HEALTHY),
    (SUSPECT, DEAD),
    (DEAD, HEALTHY),
}


@dataclasses.dataclass
class WorkerRecord:
    """One worker's registry row."""

    flat: int
    edge: int
    worker: int
    capability: Dict = dataclasses.field(default_factory=dict)
    state: str = JOINING
    last_beat_ms: float = 0.0
    consecutive_misses: int = 0
    joined_step: int = 0
    deaths: int = 0

    @property
    def live(self) -> bool:
        """Counted as a submission candidate (JOINING workers have not
        produced work yet; SUSPECT workers may still submit)."""
        return self.state in (HEALTHY, SUSPECT)

    def to_json(self) -> Dict:
        return {
            "flat": self.flat, "edge": self.edge, "worker": self.worker,
            "state": self.state, "misses": self.consecutive_misses,
            "deaths": self.deaths,
        }


class DeviceRegistry:
    """Liveness state machine over a :class:`~repro_torch.core.topology.Topology`.

    The registry is indexed by FLAT worker id (``topo.flat_index``);
    the (edge, worker) slot of each record is fixed — the control plane
    never renumbers (renumbering is what ``CodedSession.shrink`` does,
    and that is a topology change, not a liveness change).
    """

    def __init__(self, topo: Topology, log: Optional[ev.EventLog] = None):
        self.topo = topo
        self.log = log if log is not None else ev.EventLog()
        self.workers: Dict[int, WorkerRecord] = {}
        self._edge_down: Dict[int, bool] = {i: False for i in range(topo.n)}

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def register(self, edge: int, worker: int, *, step: int = 0,
                 capability: Optional[Dict] = None) -> WorkerRecord:
        flat = self.topo.flat_index(edge, worker)
        if flat in self.workers:
            raise ValueError(f"worker ({edge}, {worker}) already registered")
        rec = WorkerRecord(flat=flat, edge=edge, worker=worker,
                           capability=dict(capability or {}),
                           joined_step=step)
        self.workers[flat] = rec
        return rec

    def register_all(self, *, step: int = 0,
                     capabilities: Optional[Dict[int, Dict]] = None) -> None:
        for (i, j) in self.topo.worker_ids():
            flat = self.topo.flat_index(i, j)
            self.register(i, j, step=step,
                          capability=(capabilities or {}).get(flat))

    def record(self, flat: int) -> WorkerRecord:
        return self.workers[flat]

    # ------------------------------------------------------------------
    # transitions
    # ------------------------------------------------------------------
    def _transition(self, rec: WorkerRecord, new: str, step: int,
                    clock_ms: float, kind: str, **detail) -> None:
        if (rec.state, new) not in _TRANSITIONS:
            raise ValueError(
                f"illegal liveness transition {rec.state} -> {new} for "
                f"worker {rec.flat}"
            )
        rec.state = new
        self.log.append(ev.Event(
            kind=kind, step=step, clock_ms=clock_ms, worker=rec.flat,
            edge=rec.edge, detail=detail or {},
        ))
        self._check_edge(rec.edge, step, clock_ms)

    def beat(self, flat: int, step: int, clock_ms: float) -> None:
        """A heartbeat arrived: reset the miss budget, maybe recover."""
        rec = self.workers[flat]
        rec.last_beat_ms = clock_ms
        rec.consecutive_misses = 0
        if rec.state == JOINING:
            self._transition(rec, HEALTHY, step, clock_ms,
                             ev.WORKER_JOINED)
        elif rec.state == SUSPECT:
            self._transition(rec, HEALTHY, step, clock_ms,
                             ev.WORKER_RECOVERED)
        elif rec.state == DEAD:
            rec.deaths = rec.deaths  # rejoin keeps the death count
            self._transition(rec, HEALTHY, step, clock_ms,
                             ev.WORKER_REJOINED)

    def miss(self, flat: int, step: int, clock_ms: float, *,
             suspect_after: int, dead_after: int) -> None:
        """A heartbeat deadline passed without a beat."""
        rec = self.workers[flat]
        if rec.state == DEAD:
            return
        rec.consecutive_misses += 1
        self.log.append(ev.Event(
            kind=ev.HEARTBEAT_MISSED, step=step, clock_ms=clock_ms,
            worker=rec.flat, edge=rec.edge,
            detail={"misses": rec.consecutive_misses},
        ))
        if rec.state in (HEALTHY, JOINING) \
                and rec.consecutive_misses >= suspect_after:
            self._transition(rec, SUSPECT, step, clock_ms,
                             ev.WORKER_SUSPECT,
                             misses=rec.consecutive_misses)
        elif rec.state == SUSPECT and rec.consecutive_misses >= dead_after:
            rec.deaths += 1
            self._transition(rec, DEAD, step, clock_ms, ev.WORKER_DEAD,
                             misses=rec.consecutive_misses)

    def _check_edge(self, edge: int, step: int, clock_ms: float) -> None:
        """Derived pod liveness: emit edge_down/up on boundary crossings."""
        regs = [r for r in self.workers.values() if r.edge == edge]
        down = bool(regs) and all(r.state == DEAD for r in regs)
        if down and not self._edge_down[edge]:
            self._edge_down[edge] = True
            self.log.append(ev.Event(
                kind=ev.EDGE_DOWN, step=step, clock_ms=clock_ms,
                edge=edge, detail={"workers": len(regs)},
            ))
        elif not down and self._edge_down[edge]:
            self._edge_down[edge] = False
            self.log.append(ev.Event(
                kind=ev.EDGE_UP, step=step, clock_ms=clock_ms, edge=edge,
            ))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def state_of(self, flat: int) -> str:
        return self.workers[flat].state

    def live_workers(self) -> List[int]:
        return sorted(f for f, r in self.workers.items() if r.live)

    def dead_workers(self) -> List[int]:
        return sorted(f for f, r in self.workers.items()
                      if r.state == DEAD)

    def edge_down(self, edge: int) -> bool:
        return self._edge_down[edge]

    def down_edges(self) -> List[int]:
        return sorted(i for i, d in self._edge_down.items() if d)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATES}
        for r in self.workers.values():
            out[r.state] += 1
        return out

    def to_json(self) -> Dict:
        return {
            "m": list(self.topo.m),
            "workers": [self.workers[f].to_json()
                        for f in sorted(self.workers)],
            "down_edges": self.down_edges(),
        }
