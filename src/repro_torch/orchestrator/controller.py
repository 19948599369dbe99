"""Event-driven controller — the supervised coded training service.

The controller closes the loop the library pieces leave open: it owns a
:class:`~repro_torch.orchestrator.workers.WorkerPool` of real worker
processes, a :class:`~repro_torch.orchestrator.registry.DeviceRegistry` fed
by a :class:`~repro_torch.orchestrator.heartbeat.HeartbeatMonitor`, a
:class:`~repro_torch.orchestrator.injector.FailureInjector`, and ONE
:class:`~repro_torch.api.session.CodedSession` whose train step is
never rebuilt — the episode's whole point is that every fault the
injector throws is absorbed by runtime operands (the λ decode weights
and the tolerance).  The port's step is eager, so
``session.jit_cache_entries()`` is −1 ("cannot tell").

One round:

  1. apply scheduled injections (kill/slow/partition),
  2. dispatch the round's :class:`WorkItem` to every live worker —
     each carries the worker's eq.-(22) coefficient row and assigned
     parts over a fresh probe vector,
  3. collect results; a partitioned worker's messages are dropped at
     the master (it computed — the control plane just never hears),
  4. select the completion set by the paper's wait rule — per edge the
     ``m_i − s_w^i`` fastest responders, the ``n − s_e`` edges with the
     smallest completion times — entirely from *reported* runtimes,
  5. verify the two-stage decode numerically on the probe partials
     (Σ λ_ij·ĝ_ij must equal Σ_k s_k) — ``decode_ok``,
  6. run the train step under that completion set
     (:meth:`CodedSession.external_step`), feeding the detector the
     round's observation row,
  7. advance the virtual clock by the round's completion time, deliver
     the beats that have "arrived" by then (a straggler's beat is
     late → it flaps to SUSPECT and recovers on delivery), tick the
     heartbeat deadlines,
  8. translate this round's registry events into control actions:
     worker death / pod loss / decode fallback / rejoin → fit a fresh
     cluster model from the observation ledger
     (``CodedCluster.from_observations``) and ``session.replan`` on
     it; a structured :class:`~repro_torch.api.session.ReplanError` is
     LOGGED (``replan_errors``), never fatal,
  9. emit the round's metrics record.

If too few edges can decode (below ``n − s_e`` selectable), the round
is a ``decode_fallback``: the model update is SKIPPED (λ would not
reconstruct the gradient), the observation still lands, and the
fallback itself triggers a replan toward a tolerance the surviving
cluster can honor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.orchestrator import events as ev
from repro_torch.orchestrator.heartbeat import (Heartbeat, HeartbeatConfig,
                                          HeartbeatMonitor)
from repro_torch.orchestrator.injector import (KILL, FailureInjector,
                                         InjectionSchedule)
from repro_torch.orchestrator.metrics import MetricsSink
from repro_torch.orchestrator.registry import DeviceRegistry
from repro_torch.orchestrator.workers import (PROBE_DIM, WorkerPool, WorkItem,
                                        probe_true_sum, rows_from_params)

# event kinds that make the controller consider replanning
_REPLAN_TRIGGERS = (ev.WORKER_DEAD, ev.EDGE_DOWN, ev.WORKER_REJOINED,
                    ev.EDGE_UP, ev.DECODE_FALLBACK)


@dataclasses.dataclass
class OrchestratorConfig:
    """Episode policy knobs (all deterministic)."""

    steps: int = 12
    backend: str = "auto"           # worker pool backend
    heartbeat: Optional[HeartbeatConfig] = None  # None: derive from plan
    replan_cooldown: int = 2        # min rounds between replan attempts
    min_obs_for_fit: int = 3        # observation rows before fitting
    fit_window: int = 12            # rows handed to from_observations
    probe_dim: int = PROBE_DIM
    collect_timeout_s: float = 60.0
    verbose: bool = False


def derive_heartbeat(expected_iteration_ms: float) -> HeartbeatConfig:
    """Deadline policy scaled to the plan's expected iteration time.

    A beat is owed roughly every iteration; the timeout passes only
    when a worker runs well beyond the planner's own T̂ estimate —
    so a "miss" means *slower than the plan priced*, not noise.
    """
    t = max(float(expected_iteration_ms), 1.0)
    return HeartbeatConfig(interval_ms=t, timeout_ms=2.5 * t)


class Orchestrator:
    """Runs one supervised episode over a live :class:`CodedSession`."""

    def __init__(self, session, config: Optional[OrchestratorConfig] = None,
                 *, schedule: Optional[InjectionSchedule] = None,
                 metrics: Optional[MetricsSink] = None):
        if session.cluster is None:
            raise ValueError("orchestrator needs a training session "
                             "(cluster=None is serve-only)")
        self.session = session
        self.config = config or OrchestratorConfig()
        topo = session.cluster.topo
        self.log = ev.EventLog()
        self.registry = DeviceRegistry(topo, self.log)
        self.registry.register_all(capabilities={
            f: {"c_ms_per_part": float(session.cluster.params.c[f])}
            for f in range(topo.total_workers)
        })
        hb = self.config.heartbeat or derive_heartbeat(
            session.plan.expected_iteration_ms
            if session.plan is not None
            and session.plan.expected_iteration_ms is not None
            else 500.0
        )
        self.monitor = HeartbeatMonitor(self.registry, hb)
        self.injector = FailureInjector(
            schedule or InjectionSchedule(), topo)
        self.pool = WorkerPool(
            topo, rows_from_params(session.cluster.params),
            seed=session.seed, backend=self.config.backend,
            probe_dim=self.config.probe_dim)
        self.metrics = metrics or MetricsSink()
        self.clock_ms = 0.0
        self._pending_beats: List[Heartbeat] = []
        self._killed_at: Dict[int, float] = {}
        self._last_replan_round = -(10 ** 9)
        self._round = 0

    # ------------------------------------------------------------------
    # completion-set selection (the paper's wait rule, from reports)
    # ------------------------------------------------------------------
    def select_completion_set(self, runtimes: Dict[int, float]):
        """HGC wait rule over REPORTED runtimes.

        Per edge, the fastest ``m_i − s_w^i`` responders; an edge with
        fewer responders cannot decode and is unselectable; the
        ``n − s_e`` selectable edges with the smallest completion times
        win.  Returns ``(fast_e, fast_w, iter_ms)`` or ``None`` when
        fewer than ``n − s_e`` edges can decode (decode fallback).

        Edge upload times are drawn master-side from the cluster model
        (the worker totals cover compute + both link hops below the
        edge; the edge→master hop is the edge's own).
        """
        code = self.session.code
        topo = self.session.cluster.topo
        params = self.session.cluster.params
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.session.seed, 7919, self._round]))
        n_up = rng.geometric(1.0 - np.asarray(params.p_e))
        edge_up = n_up * np.asarray(params.tau_e)

        fast_w: List[Tuple[int, ...]] = []
        edge_T = np.full(topo.n, np.inf)
        for i in range(topo.n):
            need = topo.m[i] - code.tol.s_w_of(i)
            have = [(runtimes[topo.flat_index(i, j)], j)
                    for j in range(topo.m[i])
                    if topo.flat_index(i, j) in runtimes]
            if len(have) < need:
                fast_w.append(())
                continue
            have.sort()
            chosen = have[:need]
            fast_w.append(tuple(sorted(j for _, j in chosen)))
            edge_T[i] = edge_up[i] + max(t for t, _ in chosen)
        need_e = topo.n - code.tol.s_e
        order = np.argsort(edge_T)
        if not np.isfinite(edge_T[order[need_e - 1]]):
            return None
        fast_e = tuple(sorted(int(i) for i in order[:need_e]))
        return fast_e, fast_w, float(edge_T[order[need_e - 1]])

    # ------------------------------------------------------------------
    def _probe_decode_ok(self, results, fast_e, fast_w, probe_seed) -> bool:
        """Numeric end-to-end check of the two-stage λ decode."""
        code = self.session.code
        topo = self.session.cluster.topo
        lam = code.collapsed_weights(fast_e, fast_w)
        decoded = np.zeros(self.config.probe_dim)
        for f, r in results.items():
            if lam[f] != 0.0:
                decoded += lam[f] * r.partial
        truth = probe_true_sum(probe_seed, code.K, self.config.probe_dim)
        return bool(np.allclose(decoded, truth, rtol=1e-6, atol=1e-8))

    def _deliver_due_beats(self, step: int) -> None:
        """Deliver held-back beats whose virtual send time has passed."""
        due = [b for b in self._pending_beats
               if b.sent_ms <= self.clock_ms]
        self._pending_beats = [b for b in self._pending_beats
                               if b.sent_ms > self.clock_ms]
        for b in sorted(due, key=lambda b: (b.sent_ms, b.flat)):
            self.monitor.deliver(b, step)

    # ------------------------------------------------------------------
    def _maybe_replan(self, step: int, round_events) -> None:
        """Registry transitions → fit-from-observations → replan."""
        if not any(e.kind in _REPLAN_TRIGGERS for e in round_events):
            return
        if self._round - self._last_replan_round < self.config.replan_cooldown:
            return
        if len(self.monitor.rows) < self.config.min_obs_for_fit:
            return
        self._last_replan_round = self._round
        sess = self.session
        code = sess.code
        D_ref = float(np.mean(getattr(code, "load_array", code.load)))
        from repro_torch.api.session import ReplanError

        try:
            fitted = self.monitor.fit_cluster(
                D_ref, window=self.config.fit_window,
                alpha=sess.cluster.alpha)
            old_tol = (code.tol.s_e, code.tol.s_w)
            plan = sess.replan(cluster=fitted)
            self.metrics.bump("replans")
            self.log.append(ev.Event(
                kind=ev.REPLAN, step=step, clock_ms=self.clock_ms,
                detail={
                    "old_tol": list(old_tol),
                    "new_tol": [plan.tol.s_e, plan.tol.s_w],
                    "K": plan.K,
                    "changed": plan.code is not code,
                },
            ))
            if self.config.verbose:
                print(f"[orch] replan @ step {step}: tol {old_tol} -> "
                      f"({plan.tol.s_e}, {plan.tol.s_w}), K={plan.K}")
        except ReplanError as err:
            # structured failure: the constraint that broke and the
            # surviving topology ride the event; the episode continues
            # on the old plan
            self.metrics.bump("replan_errors")
            self.log.append(ev.Event(
                kind=ev.REPLAN_FAILED, step=step, clock_ms=self.clock_ms,
                detail={"constraint": err.constraint,
                        "m": list(err.topo.m), "error": str(err)},
            ))
            if self.config.verbose:
                print(f"[orch] replan failed @ step {step} "
                      f"({err.constraint}): {err}")

    # ------------------------------------------------------------------
    def run_round(self, step: int) -> Dict:
        """One supervised round; returns the iteration metrics record."""
        cfg = self.config
        sess = self.session
        code = sess.code
        topo = sess.cluster.topo
        t0 = time.perf_counter()

        # 1. injections
        effects = self.injector.effects(self._round)
        for inj in effects.started:
            self.metrics.bump("injections_applied")
            self.log.append(ev.Event(
                kind=ev.INJECTION, step=step, clock_ms=self.clock_ms,
                edge=inj.edge, worker=(
                    None if inj.worker is None
                    else topo.flat_index(inj.edge, inj.worker)),
                detail=inj.to_json(),
            ))
            if inj.kind == KILL:
                for f in inj.targets(topo):
                    self.pool.kill(f)
                    # virtual-time consistency: a message "sent" after
                    # the kill instant is from a computation the dead
                    # worker never finished — it must not resurrect it
                    self._killed_at[f] = self.clock_ms
                self._pending_beats = [
                    b for b in self._pending_beats
                    if not (b.flat in self._killed_at
                            and b.sent_ms > self._killed_at[b.flat])
                ]

        # 2. dispatch the round to every live worker
        probe_seed = int(np.random.SeedSequence(
            [sess.seed, 15485863, self._round]).generate_state(1)[0])
        load_arr = getattr(code, "load_array", None)
        expected: Set[int] = set()
        for i in range(topo.n):
            for j in range(topo.m[i]):
                f = topo.flat_index(i, j)
                D = float(load_arr[f]) if load_arr is not None \
                    else float(code.load)
                ok = self.pool.dispatch(f, WorkItem(
                    step=self._round, clock_ms=self.clock_ms,
                    coeffs=np.asarray(code.worker_coeffs(i, j)),
                    parts=tuple(code.assignment.worker_parts(i, j)),
                    D=D, probe_seed=probe_seed, probe_dim=cfg.probe_dim,
                    slow_factor=effects.slow_factor(f),
                ))
                if ok:
                    expected.add(f)

        # 3. collect; partition drops messages AT THE MASTER
        raw = self.pool.collect(self._round, expected,
                                timeout_s=cfg.collect_timeout_s)
        results = {f: r for f, r in raw.items()
                   if f not in effects.partitioned}

        # 4. completion set by the wait rule
        runtimes = {f: r.runtime_ms for f, r in results.items()}
        sel = self.select_completion_set(runtimes)

        # 5./6. decode check + the train step
        decode_ok = False
        loss = float("nan")
        n_counted = 0
        if sel is not None:
            fast_e, fast_w, iter_ms = sel
            decode_ok = self._probe_decode_ok(
                results, fast_e, fast_w, probe_seed)
            n_counted = sum(len(fast_w[i]) for i in fast_e)
            totals = {f: r.runtime_ms for f, r in results.items()}
            obs_row = self.monitor.record_round(totals)
            m = sess.external_step(fast_e, fast_w,
                                   worker_totals=obs_row,
                                   sim_iter_ms=iter_ms)
            loss = float(m["loss"])
        else:
            # decode fallback: no λ reconstructs the gradient — skip
            # the update, keep the observation, trigger a replan
            self.metrics.bump("decode_fallbacks")
            iter_ms = (max(runtimes.values())
                       if runtimes else self.monitor.config.timeout_ms)
            fast_e, fast_w = (), []
            totals = {f: r.runtime_ms for f, r in results.items()}
            obs_row = self.monitor.record_round(totals)
            sess.cluster.observe(obs_row)
            self.log.append(ev.Event(
                kind=ev.DECODE_FALLBACK, step=step,
                clock_ms=self.clock_ms,
                detail={"responders": len(results),
                        "need_edges": topo.n - code.tol.s_e},
            ))

        straggler_hit = len(results) > n_counted
        if straggler_hit and sel is not None:
            self.metrics.bump("straggler_hits")

        # 7. clock advance + beat delivery + deadline tick
        self.clock_ms += iter_ms
        for f, r in sorted(results.items()):
            if f in self._killed_at and r.sent_ms > self._killed_at[f]:
                continue
            self._pending_beats.append(Heartbeat(
                flat=f, sent_ms=r.sent_ms, runtime_ms=r.runtime_ms))
        self._deliver_due_beats(step)
        misses = self.monitor.tick(step, self.clock_ms)
        if misses:
            self.metrics.bump("heartbeat_misses", misses)

        # 8. events → control actions
        round_events = self.log.drain_new()
        for e in round_events:
            if e.kind == ev.WORKER_RECOVERED:
                self.metrics.bump("flaps")
            elif e.kind == ev.WORKER_REJOINED:
                self.metrics.bump("rejoins")
        self._maybe_replan(step, round_events)
        round_events += self.log.drain_new()  # replan/replan_failed

        # 9. metrics
        rec = self.metrics.iteration(
            step=step, clock_ms=self.clock_ms, loss=loss,
            iter_ms=iter_ms, fast_e=fast_e, fast_w=fast_w,
            n_results=len(results), n_counted=n_counted,
            straggler_hit=straggler_hit, decode_ok=decode_ok,
            heartbeat_misses=misses, states=self.registry.counts(),
            round_events=round_events,
            wall_us=(time.perf_counter() - t0) * 1e6,
        )
        self._round += 1
        return rec

    # ------------------------------------------------------------------
    def run_episode(self, steps: Optional[int] = None) -> Dict:
        """Run the supervised episode; returns the summary record."""
        n = steps if steps is not None else self.config.steps
        started_here = not self.pool._started
        if started_here:
            self.pool.start()
        try:
            for _ in range(n):
                step = self.session._step
                rec = self.run_round(step)
                if self.config.verbose:
                    print(f"[orch] step {step} loss {rec['loss']:.4f} "
                          f"iter {rec['iter_ms']:.0f} ms "
                          f"counted {rec['n_counted']}/{rec['n_results']} "
                          f"states {rec['states']}")
        finally:
            if started_here:
                self.pool.close()
        return self.finalize(n)

    def finalize(self, steps: int) -> Dict:
        """Write the episode summary record."""
        detect = self.log.first(ev.WORKER_SUSPECT, ev.WORKER_DEAD,
                                ev.EDGE_DOWN)
        replan = self.log.first(ev.REPLAN)
        d2r = (replan.clock_ms - detect.clock_ms
               if detect is not None and replan is not None
               and replan.clock_ms >= detect.clock_ms else None)
        losses = self.session.losses
        summary = self.metrics.summary(
            steps=steps,
            jit_cache_entries=self.session.jit_cache_entries(),
            final_loss=float(losses[-1]) if losses else float("nan"),
            episode_ms=self.clock_ms,
            detect_to_replan_ms=d2r,
            extra={
                "injections": [x.to_json()
                               for x in self.injector.schedule.injections],
                "event_counts": self.log.counts(),
                "backend": self.pool.backend,
            },
        )
        self.metrics.close()
        return summary
