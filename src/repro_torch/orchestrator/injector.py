"""Failure injector — deterministic, schedulable fault injection.

The paper's premise is that edge deployments fail in structured ways:
workers die, whole edge pods drop off the network, links degrade.  The
injector turns those into first-class, *scheduled* events against the
worker pool:

  * ``kill``      — terminate a worker (or a whole edge pod) for good:
    the process/thread stops responding permanently,
  * ``slow``      — multiply the target's compute time by ``factor``
    for ``duration`` rounds (a transient straggler / thermal event),
  * ``partition`` — drop the target's messages at the master for
    ``duration`` rounds; the worker keeps computing, the control plane
    sees silence, and when the partition heals the worker REJOINS —
    the flap/recovery path of the liveness machine.

Schedules are either parsed from a compact spec string (the CLI's
``--inject``) or drawn from a seeded RNG (``InjectionSchedule.seeded``)
— both fully deterministic, so CI episodes replay exactly.

Spec grammar (comma-separated)::

    kind:target@step[xduration][:factor]

    kill:w0.1@3        kill worker (edge 0, worker 1) at step 3
    kill:e1@4          kill ALL of edge 1's workers at step 4
    slow:e1@5x3:4.0    slow edge 1 by 4x for rounds 5,6,7
    partition:w1.0@2x2 drop worker (1,0)'s messages for rounds 2,3
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import Topology

KILL = "kill"
SLOW = "slow"
PARTITION = "partition"
KINDS = (KILL, SLOW, PARTITION)

_SPEC_RE = re.compile(
    r"^(?P<kind>kill|slow|partition):"
    r"(?P<target>[we]\d+(?:\.\d+)?)"
    r"@(?P<step>\d+)"
    r"(?:x(?P<duration>\d+))?"
    r"(?::(?P<factor>\d+(?:\.\d+)?))?$"
)


@dataclasses.dataclass(frozen=True)
class Injection:
    """One scheduled fault.

    ``edge``/``worker``: worker-level faults set both; edge-level faults
    set ``worker=None`` and apply to every worker of the edge.  ``kill``
    ignores ``duration`` (permanent); ``slow``/``partition`` last
    ``duration`` rounds starting at ``step``.
    """

    kind: str
    step: int
    edge: int
    worker: Optional[int] = None
    duration: int = 1
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown injection kind {self.kind!r}")
        if self.step < 0 or self.duration < 1:
            raise ValueError("injection needs step >= 0, duration >= 1")
        if self.kind == SLOW and self.factor <= 1.0:
            raise ValueError(f"slow factor must exceed 1, got {self.factor}")

    def active(self, step: int) -> bool:
        if self.kind == KILL:
            return step >= self.step
        return self.step <= step < self.step + self.duration

    def targets(self, topo: Topology) -> Tuple[int, ...]:
        """Flat worker indices this injection hits."""
        if self.worker is not None:
            return (topo.flat_index(self.edge, self.worker),)
        return tuple(topo.flat_index(self.edge, j)
                     for j in range(topo.m[self.edge]))

    def to_json(self) -> Dict:
        d = {"kind": self.kind, "step": self.step, "edge": self.edge}
        if self.worker is not None:
            d["worker"] = self.worker
        if self.kind != KILL:
            d["duration"] = self.duration
        if self.kind == SLOW:
            d["factor"] = self.factor
        return d

    @property
    def spec(self) -> str:
        t = (f"e{self.edge}" if self.worker is None
             else f"w{self.edge}.{self.worker}")
        s = f"{self.kind}:{t}@{self.step}"
        if self.kind != KILL and self.duration != 1:
            s += f"x{self.duration}"
        if self.kind == SLOW:
            s += f":{self.factor:g}"
        return s


@dataclasses.dataclass(frozen=True)
class RoundEffects:
    """The injector's verdict for one round, consumed by the pool."""

    killed: FrozenSet[int]                 # flat ids: stop permanently
    partitioned: FrozenSet[int]            # flat ids: drop messages
    slow: Dict[int, float]                 # flat id -> compute multiplier
    started: Tuple[Injection, ...]         # injections starting this round

    def slow_factor(self, flat: int) -> float:
        return self.slow.get(flat, 1.0)


class InjectionSchedule:
    """An ordered, deterministic set of :class:`Injection`."""

    def __init__(self, injections: Sequence[Injection] = ()):
        self.injections = tuple(sorted(
            injections, key=lambda x: (x.step, x.kind, x.edge,
                                       -1 if x.worker is None else x.worker)
        ))

    @classmethod
    def parse(cls, spec: str) -> "InjectionSchedule":
        """Parse the CLI grammar (see module docstring)."""
        out: List[Injection] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _SPEC_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad injection spec {part!r} — expected "
                    f"kind:target@step[xduration][:factor], e.g. "
                    f"kill:w0.1@3 or slow:e1@5x3:4.0"
                )
            target = m.group("target")
            if target[0] == "w":
                if "." not in target:
                    raise ValueError(
                        f"worker target needs edge.worker, got {part!r}"
                    )
                e, w = target[1:].split(".")
                edge, worker = int(e), int(w)
            else:
                edge, worker = int(target[1:].split(".")[0]), None
            kw = {}
            if m.group("duration"):
                kw["duration"] = int(m.group("duration"))
            if m.group("factor"):
                kw["factor"] = float(m.group("factor"))
            out.append(Injection(kind=m.group("kind"),
                                 step=int(m.group("step")),
                                 edge=edge, worker=worker, **kw))
        return cls(out)

    @classmethod
    def seeded(cls, seed: int, topo: Topology, steps: int, *,
               n_events: int = 3, kinds: Sequence[str] = KINDS,
               max_kills: int = 1) -> "InjectionSchedule":
        """A random-but-reproducible schedule for soak tests.

        Kills are capped at ``max_kills`` single workers (never a whole
        edge) so a seeded soak stays inside one worker-tolerance level;
        slow/partition events target workers or edges freely.
        """
        rng = np.random.default_rng(np.random.SeedSequence([seed, 6271]))
        out: List[Injection] = []
        kills = 0
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            if kind == KILL and kills >= max_kills:
                kind = SLOW
            step = int(rng.integers(1, max(steps - 2, 2)))
            edge = int(rng.integers(0, topo.n))
            worker: Optional[int] = int(rng.integers(0, topo.m[edge]))
            if kind != KILL and rng.random() < 0.3:
                worker = None  # pod-level event
            kw = {}
            if kind != KILL:
                kw["duration"] = int(rng.integers(1, 4))
            if kind == SLOW:
                kw["factor"] = float(np.round(rng.uniform(2.0, 6.0), 2))
            if kind == KILL:
                kills += 1
            out.append(Injection(kind=kind, step=step, edge=edge,
                                 worker=worker, **kw))
        return cls(out)

    def spec(self) -> str:
        return ",".join(x.spec for x in self.injections)

    def __len__(self) -> int:
        return len(self.injections)


class FailureInjector:
    """Evaluates the schedule against the episode's round counter."""

    def __init__(self, schedule: InjectionSchedule, topo: Topology):
        self.schedule = schedule
        self.topo = topo
        self.applied = 0

    def effects(self, step: int) -> RoundEffects:
        killed: set = set()
        partitioned: set = set()
        slow: Dict[int, float] = {}
        started: List[Injection] = []
        for inj in self.schedule.injections:
            if not inj.active(step):
                continue
            if inj.step == step:
                started.append(inj)
                self.applied += 1
            for flat in inj.targets(self.topo):
                if inj.kind == KILL:
                    killed.add(flat)
                elif inj.kind == PARTITION:
                    partitioned.add(flat)
                else:
                    slow[flat] = max(slow.get(flat, 1.0), inj.factor)
        return RoundEffects(killed=frozenset(killed),
                            partitioned=frozenset(partitioned),
                            slow=slow, started=tuple(started))
