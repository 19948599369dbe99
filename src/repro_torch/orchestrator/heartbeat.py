"""Heartbeat monitor — liveness deadlines + the observation ledger.

Two jobs, one tick:

  * **liveness** — each live worker owes a beat every ``interval_ms``
    on the episode's virtual clock; a worker whose silence exceeds
    ``timeout_ms × backoff^misses`` is missed (the backoff widens the
    deadline for already-suspect workers so one slow link does not
    escalate straight to DEAD), and the registry's state machine turns
    consecutive misses into SUSPECT/DEAD transitions,
  * **observation** — every beat carries the worker's last per-iteration
    total (an eq.-31 sample); the monitor keeps a per-worker EWMA *and*
    the full per-round rows, because the two consumers want different
    things: the EWMA fills the rows of silent workers (a dead worker
    still occupies a row — its staleness is exactly what the fit should
    see as "slow"), and the complete row matrix is what
    :meth:`fit_cluster` hands to ``CodedCluster.from_observations`` to
    close the paper's fit-replan loop from *measured* delays.

The monitor never touches wall time: the controller advances the
virtual clock by each round's simulated iteration time, so tests and
CI replay byte-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.orchestrator.registry import DEAD, JOINING, DeviceRegistry


@dataclasses.dataclass(frozen=True)
class HeartbeatConfig:
    """Deadline policy on the virtual clock (all times in ms).

    ``suspect_after``/``dead_after`` are CONSECUTIVE missed deadlines:
    with the defaults a worker is SUSPECT after its first miss and DEAD
    after three, each deadline ``backoff×`` wider than the last.
    ``miss_fill_factor`` scales the observation filled in for a silent
    worker (relative to its EWMA / the round's slowest responder) so
    the cluster fit sees silence as slowness.
    """

    interval_ms: float = 100.0
    timeout_ms: float = 300.0
    backoff: float = 1.5
    suspect_after: int = 1
    dead_after: int = 3
    miss_fill_factor: float = 2.0
    join_grace_factor: float = 4.0

    def __post_init__(self):
        if self.interval_ms <= 0 or self.timeout_ms <= 0:
            raise ValueError("heartbeat interval/timeout must be > 0")
        if self.join_grace_factor < 1.0:
            raise ValueError("join_grace_factor must be >= 1.0")
        if self.timeout_ms < self.interval_ms:
            raise ValueError(
                f"timeout_ms={self.timeout_ms} below interval_ms="
                f"{self.interval_ms} — every beat would be late"
            )
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1.0")
        if not (0 < self.suspect_after <= self.dead_after):
            raise ValueError(
                "need 0 < suspect_after <= dead_after misses"
            )


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """One beat: worker identity + its latest runtime observation."""

    flat: int
    sent_ms: float
    runtime_ms: Optional[float] = None  # eq.-31 total of the last round


class HeartbeatMonitor:
    """Deadline evaluation + EWMA runtime ledger over the registry."""

    def __init__(self, registry: DeviceRegistry,
                 config: Optional[HeartbeatConfig] = None, *,
                 ewma_alpha: float = 0.3):
        self.registry = registry
        self.config = config or HeartbeatConfig()
        self.ewma_alpha = float(ewma_alpha)
        self.ewma: Dict[int, float] = {}
        self.rows: List[np.ndarray] = []   # complete per-round obs rows
        self.misses_total = 0
        self.beats_total = 0

    @property
    def topo(self) -> Topology:
        return self.registry.topo

    # ------------------------------------------------------------------
    def deliver(self, beat: Heartbeat, step: int) -> None:
        """Process one beat (registry transition + EWMA update).

        Safe at ANY time — including while a replan is in flight: the
        monitor only mutates its own ledger and the registry row, never
        the session, so a beat that races a replan lands in the next
        round's deadline evaluation instead of corrupting anything.
        """
        self.beats_total += 1
        self.registry.beat(beat.flat, step, beat.sent_ms)
        if beat.runtime_ms is not None:
            prev = self.ewma.get(beat.flat)
            self.ewma[beat.flat] = (
                float(beat.runtime_ms) if prev is None
                else (1 - self.ewma_alpha) * prev
                + self.ewma_alpha * float(beat.runtime_ms)
            )

    def tick(self, step: int, now_ms: float) -> int:
        """Evaluate deadlines at virtual time ``now_ms``; returns the
        number of misses charged this tick."""
        cfg = self.config
        missed = 0
        for flat, rec in sorted(self.registry.workers.items()):
            if rec.state == DEAD:
                continue
            if rec.state == JOINING and rec.consecutive_misses == 0:
                # a worker that never beat yet gets the (wider) join
                # grace before its first miss — slow first rounds are
                # normal on a heterogeneous edge, silence forever not
                deadline = cfg.timeout_ms * cfg.join_grace_factor
            else:
                deadline = cfg.timeout_ms * (
                    cfg.backoff ** rec.consecutive_misses)
            if now_ms - rec.last_beat_ms > deadline:
                self.registry.miss(
                    flat, step, now_ms,
                    suspect_after=cfg.suspect_after,
                    dead_after=cfg.dead_after,
                )
                missed += 1
        self.misses_total += missed
        return missed

    # ------------------------------------------------------------------
    # the observation ledger
    # ------------------------------------------------------------------
    def record_round(self, totals: Dict[int, float]) -> np.ndarray:
        """Close one round's observation row.

        ``totals`` maps flat worker index → observed eq.-31 total for
        the workers that responded; silent workers are filled with
        ``miss_fill_factor ×`` their EWMA (or the round's slowest
        responder when no history exists) — a conservative "at least
        this slow" that keeps the fit matrix rectangular and makes
        persistent silence look persistently slow.
        """
        W = self.topo.total_workers
        row = np.empty(W, np.float64)
        responded = [t for t in totals.values() if t is not None]
        slowest = max(responded) if responded else self.config.timeout_ms
        for flat in range(W):
            t = totals.get(flat)
            if t is None:
                base = self.ewma.get(flat, slowest)
                t = self.config.miss_fill_factor * base
            row[flat] = float(t)
            prev = self.ewma.get(flat)
            self.ewma[flat] = (
                row[flat] if prev is None
                else (1 - self.ewma_alpha) * prev
                + self.ewma_alpha * row[flat]
            )
        self.rows.append(row)
        return row

    def observation_matrix(self, window: int = 0) -> np.ndarray:
        """(rounds × W) matrix of the last ``window`` rows (0 = all)."""
        rows = self.rows[-window:] if window else self.rows
        if not rows:
            return np.empty((0, self.topo.total_workers))
        return np.stack(rows, axis=0)

    def fit_cluster(self, D: float, *, window: int = 0, **priors):
        """Fit a fresh ``CodedCluster`` from the observed rows.

        The fit-replan loop's closing move: per-worker compute rates are
        fitted so the model's expected eq.-31 totals match the observed
        means at load ``D`` (``CodedCluster.from_observations``), and
        the returned cluster's detector is warm-started with the same
        rows — the next planner pass prices *measured* delays.
        """
        from repro_torch.api.cluster import CodedCluster

        obs = self.observation_matrix(window)
        if obs.shape[0] == 0:
            raise ValueError("no observation rows recorded yet")
        return CodedCluster.from_observations(self.topo, obs, D, **priors)
