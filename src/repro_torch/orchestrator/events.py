"""Control-plane events — the vocabulary of the liveness state machine.

Every registry transition, injection, and controller action is recorded
as one :class:`Event`; the controller consumes the stream to decide
replans and the metrics sink persists it (the JSONL ``events`` field).
Events are plain data — no callbacks, no threads — so episodes replay
deterministically and tests can assert on exact sequences.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# ---- event kinds (stable strings: part of the metrics schema) --------
WORKER_JOINED = "worker_joined"
HEARTBEAT_MISSED = "heartbeat_missed"
WORKER_SUSPECT = "worker_suspect"
WORKER_DEAD = "worker_dead"
WORKER_RECOVERED = "worker_recovered"   # SUSPECT -> HEALTHY
WORKER_REJOINED = "worker_rejoined"     # DEAD -> HEALTHY (heal)
EDGE_DOWN = "edge_down"
EDGE_UP = "edge_up"
INJECTION = "injection"
DECODE_FALLBACK = "decode_fallback"
REPLAN = "replan"
REPLAN_FAILED = "replan_failed"
SHRINK = "shrink"

EVENT_KINDS = (
    WORKER_JOINED, HEARTBEAT_MISSED, WORKER_SUSPECT, WORKER_DEAD,
    WORKER_RECOVERED, WORKER_REJOINED, EDGE_DOWN, EDGE_UP, INJECTION,
    DECODE_FALLBACK, REPLAN, REPLAN_FAILED, SHRINK,
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One control-plane occurrence on the episode's virtual clock.

    ``worker`` is the flat worker index (``Topology.flat_index``),
    ``edge`` the edge index; either may be ``None`` for cluster-level
    events.  ``detail`` carries kind-specific payload (all values
    JSON-serializable — the metrics sink writes events verbatim).
    """

    kind: str
    step: int
    clock_ms: float
    worker: Optional[int] = None
    edge: Optional[int] = None
    detail: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")

    def to_json(self) -> Dict:
        d = {"kind": self.kind, "step": self.step,
             "clock_ms": round(float(self.clock_ms), 3)}
        if self.worker is not None:
            d["worker"] = int(self.worker)
        if self.edge is not None:
            d["edge"] = int(self.edge)
        if self.detail:
            d["detail"] = self.detail
        return d


class EventLog:
    """Append-only episode event record with step-window draining.

    The controller appends during a round and drains the new slice into
    that round's metrics record; ``of_kind`` serves tests and the bench
    (detection-to-replan latency = first ``worker_dead``/``suspect`` to
    first ``replan``).
    """

    def __init__(self):
        self.events: List[Event] = []
        self._drained = 0

    def append(self, event: Event) -> Event:
        self.events.append(event)
        return event

    def drain_new(self) -> List[Event]:
        """Events appended since the previous drain (one round's worth)."""
        new = self.events[self._drained:]
        self._drained = len(self.events)
        return new

    def of_kind(self, *kinds: str) -> List[Event]:
        return [e for e in self.events if e.kind in kinds]

    def first(self, *kinds: str) -> Optional[Event]:
        for e in self.events:
            if e.kind in kinds:
                return e
        return None

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.events)
