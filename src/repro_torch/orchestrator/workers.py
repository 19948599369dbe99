"""Worker pool — real concurrent workers under the control plane.

Each worker of the topology runs as its own OS process (or thread,
where the runner lacks cores) and, per round, performs the *worker side
of eq. (22)*: it receives its coded coefficient row and assigned parts,
computes the encoded partial over a probe vector per part, draws its
iteration runtime from its own slice of the runtime model (eq. 31 —
compute + worker-link + edge-download terms, all seeded by
``(seed, worker, step)`` so every backend replays identically), and
submits a :class:`Result` whose embedded heartbeat is stamped with the
VIRTUAL completion time ``dispatch clock + runtime``.

That stamp is the trick that makes the control plane honest without
wall-clock flakiness: a worker whose simulated round ran long delivers
a heartbeat that is genuinely *late* on the episode clock — the monitor
sees a missed deadline, the registry flaps it to SUSPECT, and its
recovery on the next round exercises the same state-machine path a real
deployment would, deterministically.

Workers never import torch: the gradient step stays on the master (the
coded train step on the card); what the pool distributes is the encoded
per-worker computation and the runtime/liveness ground truth the
orchestrator decodes and plans from.  The probe partials flow through
the SAME λ the train step consumes, so every round carries an
end-to-end numeric check of the two-stage decode under the live
completion set (``decode_ok``).
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_lib
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.topology import Topology

PROBE_DIM = 32


@dataclasses.dataclass(frozen=True)
class ModelRow:
    """One worker's slice of the cluster runtime model (priors or fit)."""

    c: float          # per-part compute ms
    gamma: float      # exponential noise rate
    tau_w: float      # worker-link delay ms
    p_w: float        # worker-link loss probability
    tau_e: float      # edge-link delay ms (download hop)
    p_e: float        # edge-link loss probability


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One round's assignment for one worker."""

    step: int
    clock_ms: float          # virtual dispatch time
    coeffs: np.ndarray       # (K,) effective coded coefficients
    parts: Tuple[int, ...]   # assigned global part ids
    D: float                 # per-worker load (parts per iteration)
    probe_seed: int
    probe_dim: int = PROBE_DIM
    slow_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class Result:
    """One worker's round submission (result + piggybacked beat)."""

    flat: int
    step: int
    runtime_ms: float        # simulated eq.-31 total (slow-factor applied)
    sent_ms: float           # virtual completion time (the beat stamp)
    partial: np.ndarray      # encoded probe partial  Σ_k coeffs[k]·s_k
    wall_us: float           # real compute wall time (metrics only)


def probe_part_vector(probe_seed: int, k: int, dim: int) -> np.ndarray:
    """The deterministic probe "gradient" of part ``k`` this round."""
    rng = np.random.default_rng(np.random.SeedSequence([probe_seed, k]))
    return rng.standard_normal(dim)


def probe_true_sum(probe_seed: int, K: int, dim: int) -> np.ndarray:
    """Σ_k s_k — what an exact decode of the partials must recover."""
    out = np.zeros(dim)
    for k in range(K):
        out += probe_part_vector(probe_seed, k, dim)
    return out


def draw_runtime_ms(row: ModelRow, flat: int, step: int, seed: int,
                    D: float, slow_factor: float = 1.0) -> float:
    """Eq.-31 sample for one worker, seeded by (seed, worker, step).

    Mirrors ``ClusterParams.sample_iteration`` per worker (compute +
    2 worker-link transfers + the edge download hop); the injected
    ``slow_factor`` scales the deterministic compute term — a slow
    *device*, not a lossy link.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 104729, flat, step])
    )
    t_cmp = row.c * D * slow_factor + rng.exponential(1.0 / row.gamma)
    n_dl = rng.geometric(1.0 - row.p_w)
    n_ul = rng.geometric(1.0 - row.p_w)
    n_edl = rng.geometric(1.0 - row.p_e)
    return float(n_edl * row.tau_e + (n_dl + n_ul) * row.tau_w + t_cmp)


def _worker_main(flat: int, row: ModelRow, seed: int, inbox, outbox):
    """The worker loop (runs in a child process or thread).

    numpy-only on purpose: process children must never pay for the
    torch import — the model step is the master's job.
    """
    while True:
        msg = inbox.get()
        if msg[0] == "stop":
            return
        work: WorkItem = msg[1]
        t0 = time.perf_counter()
        runtime = draw_runtime_ms(row, flat, work.step, seed, work.D,
                                  work.slow_factor)
        partial = np.zeros(work.probe_dim)
        for k in work.parts:
            partial += work.coeffs[k] * probe_part_vector(
                work.probe_seed, k, work.probe_dim
            )
        outbox.put(("result", Result(
            flat=flat, step=work.step, runtime_ms=runtime,
            sent_ms=work.clock_ms + runtime, partial=partial,
            wall_us=(time.perf_counter() - t0) * 1e6,
        )))


def resolve_backend(backend: str = "auto") -> str:
    """``auto`` uses processes when the runner has cores to spare."""
    if backend not in ("auto", "process", "thread"):
        raise ValueError(f"unknown worker backend {backend!r}")
    if backend != "auto":
        return backend
    return "process" if (os.cpu_count() or 1) >= 2 else "thread"


class WorkerPool:
    """N workers as OS processes (or threads) + the message plumbing.

    One inbox queue per worker, one shared outbox.  ``kill`` terminates
    the worker for good (process SIGTERM / thread poison) — the control
    plane is NOT told, by design: death must be *detected* via missed
    heartbeats, that is the point of the monitor.
    """

    def __init__(self, topo: Topology, rows: Sequence[ModelRow], *,
                 seed: int = 0, backend: str = "auto",
                 probe_dim: int = PROBE_DIM):
        if len(rows) != topo.total_workers:
            raise ValueError(
                f"need one ModelRow per worker "
                f"({topo.total_workers}), got {len(rows)}"
            )
        self.topo = topo
        self.rows = list(rows)
        self.seed = seed
        self.backend = resolve_backend(backend)
        self.probe_dim = probe_dim
        self._inboxes: Dict[int, object] = {}
        self._outbox = None
        self._handles: Dict[int, object] = {}
        self._alive: Set[int] = set()
        self._started = False

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        if self.backend == "process":
            import multiprocessing as mp

            # spawn, not fork: a forked child of a CUDA parent cannot use
            # CUDA and inherits the locks of the master's threads;
            # spawned children import only this numpy-only module
            ctx = mp.get_context("spawn")
            self._outbox = ctx.Queue()
            make_inbox = ctx.Queue

            def launch(flat, row, inbox):
                p = ctx.Process(
                    target=_worker_main,
                    args=(flat, row, self.seed, inbox, self._outbox),
                    daemon=True,
                )
                p.start()
                return p
        else:
            self._outbox = queue_lib.Queue()
            make_inbox = queue_lib.Queue

            def launch(flat, row, inbox):
                t = threading.Thread(
                    target=_worker_main,
                    args=(flat, row, self.seed, inbox, self._outbox),
                    daemon=True,
                )
                t.start()
                return t
        for flat in range(self.topo.total_workers):
            inbox = make_inbox()
            self._inboxes[flat] = inbox
            self._handles[flat] = launch(flat, self.rows[flat], inbox)
            self._alive.add(flat)

    @property
    def alive(self) -> Set[int]:
        return set(self._alive)

    # ------------------------------------------------------------------
    def dispatch(self, flat: int, work: WorkItem) -> bool:
        """Send one round's work item; False if the worker is dead."""
        if flat not in self._alive:
            return False
        self._inboxes[flat].put(("work", work))
        return True

    def collect(self, step: int, expected: Set[int], *,
                timeout_s: float = 60.0) -> Dict[int, Result]:
        """Drain results for ``step`` from every expected live worker.

        REAL time only bounds the wait for processes to finish their
        (fast) numpy work — all *scheduling* semantics ride the virtual
        ``sent_ms`` stamps, so a slow CI runner changes nothing.  Stale
        results from earlier rounds (a worker killed mid-collect last
        round) are dropped.
        """
        results: Dict[int, Result] = {}
        pending = {f for f in expected if f in self._alive}
        deadline = time.monotonic() + timeout_s
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                msg = self._outbox.get(timeout=min(remaining, 0.5))
            except queue_lib.Empty:
                continue
            except Exception:  # mp.Queue raises its own Empty
                continue
            if msg[0] != "result":
                continue
            res: Result = msg[1]
            if res.step != step:
                continue
            results[res.flat] = res
            pending.discard(res.flat)
        return results

    def inject_message(self, msg) -> None:
        """Test hook: push a raw message into the master's inbox."""
        self._outbox.put(msg)

    # ------------------------------------------------------------------
    def kill(self, flat: int) -> bool:
        """Terminate a worker permanently; True if it was alive."""
        if flat not in self._alive:
            return False
        self._alive.discard(flat)
        h = self._handles[flat]
        if self.backend == "process":
            h.terminate()
        else:
            self._inboxes[flat].put(("stop",))
        return True

    def close(self) -> None:
        for flat in list(self._alive):
            self._alive.discard(flat)
            if self.backend == "process":
                self._handles[flat].terminate()
            else:
                self._inboxes[flat].put(("stop",))
        for flat, h in self._handles.items():
            h.join(timeout=5.0)

    def __enter__(self) -> "WorkerPool":
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def rows_from_params(params) -> List[ModelRow]:
    """Per-worker :class:`ModelRow` slices of a ``ClusterParams``."""
    topo = params.topo
    rows = []
    for i in range(topo.n):
        for j in range(topo.m[i]):
            f = topo.flat_index(i, j)
            rows.append(ModelRow(
                c=float(params.c[f]), gamma=float(params.gamma[f]),
                tau_w=float(params.tau_w[f]), p_w=float(params.p_w[f]),
                tau_e=float(params.tau_e[i]), p_e=float(params.p_e[i]),
            ))
    return rows
