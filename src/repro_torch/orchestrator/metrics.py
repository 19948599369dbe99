"""Metrics layer — per-iteration JSONL sink + episode counters.

One JSON object per line, schema-versioned so downstream consumers
(``benchmarks/bench_orchestrator.py``, the CI gate, dashboards) can
parse blind.  Two record types share the stream:

``{"record": "iteration", ...}`` — one per training round::

    schema, step, clock_ms, loss, iter_ms,
    fast_e / fast_w          — the completion set the decode used
    n_results, n_counted     — responders vs workers inside the λ
    straggler_hit            — at least one live worker left out
    decode_ok                — probe-vector λ-decode matched Σ s_k
    heartbeat_misses         — deadline misses charged this round
    states                   — registry liveness census
    events                   — control-plane events this round
    wall_us                  — real master-side wall time (info only)

``{"record": "summary", ...}`` — one final line::

    schema, steps, counters{straggler_hits, replans, replan_errors,
    shrinks, heartbeat_misses, decode_fallbacks, injections_applied,
    flaps, rejoins}, jit_cache_entries, final_loss, episode_ms,
    detect_to_replan_ms      — first suspect/dead event -> first replan

Counters are monotone over the episode; ``iteration`` records carry the
*per-round* deltas so the stream integrates back to the summary.  The
sink buffers when constructed with ``path=None`` (tests, the bench) and
streams line-by-line otherwise (``flush`` per record — an episode that
dies mid-run still leaves parseable metrics).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.orchestrator import events as ev

METRICS_SCHEMA_VERSION = 1

# counter names are part of the schema — tests pin this tuple
COUNTERS = (
    "straggler_hits",
    "replans",
    "replan_errors",
    "shrinks",
    "heartbeat_misses",
    "decode_fallbacks",
    "injections_applied",
    "flaps",
    "rejoins",
)


class MetricsSink:
    """JSONL writer + the episode's counter block."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.counters: Dict[str, int] = {k: 0 for k in COUNTERS}
        self.records: List[Dict] = []
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "w", encoding="utf-8")

    # ------------------------------------------------------------------
    def bump(self, counter: str, by: int = 1) -> None:
        if counter not in self.counters:
            raise KeyError(
                f"unknown counter {counter!r}; schema v"
                f"{METRICS_SCHEMA_VERSION} counters are {COUNTERS}"
            )
        self.counters[counter] += by

    def _emit(self, record: Dict) -> None:
        self.records.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    # ------------------------------------------------------------------
    def iteration(self, *, step: int, clock_ms: float, loss: float,
                  iter_ms: float, fast_e: Sequence[int],
                  fast_w: Sequence[Sequence[int]], n_results: int,
                  n_counted: int, straggler_hit: bool, decode_ok: bool,
                  heartbeat_misses: int, states: Dict[str, int],
                  round_events: Sequence[ev.Event],
                  wall_us: float) -> Dict:
        rec = {
            "record": "iteration",
            "schema": METRICS_SCHEMA_VERSION,
            "step": int(step),
            "clock_ms": round(float(clock_ms), 3),
            "loss": float(loss),
            "iter_ms": round(float(iter_ms), 3),
            "fast_e": [int(i) for i in fast_e],
            "fast_w": [[int(j) for j in w] for w in fast_w],
            "n_results": int(n_results),
            "n_counted": int(n_counted),
            "straggler_hit": bool(straggler_hit),
            "decode_ok": bool(decode_ok),
            "heartbeat_misses": int(heartbeat_misses),
            "states": dict(states),
            "events": [e.to_json() for e in round_events],
            "wall_us": round(float(wall_us), 1),
        }
        self._emit(rec)
        return rec

    def summary(self, *, steps: int, jit_cache_entries: int,
                final_loss: float, episode_ms: float,
                detect_to_replan_ms: Optional[float] = None,
                extra: Optional[Dict] = None) -> Dict:
        rec = {
            "record": "summary",
            "schema": METRICS_SCHEMA_VERSION,
            "steps": int(steps),
            "counters": dict(self.counters),
            "jit_cache_entries": int(jit_cache_entries),
            "final_loss": float(final_loss),
            "episode_ms": round(float(episode_ms), 3),
        }
        if detect_to_replan_ms is not None:
            rec["detect_to_replan_ms"] = round(float(detect_to_replan_ms), 3)
        if extra:
            rec.update(extra)
        self._emit(rec)
        return rec

    # ------------------------------------------------------------------
    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str) -> Dict[str, List[Dict]]:
    """Parse a metrics JSONL file into ``{"iteration": [...], "summary":
    [...]}`` — the helper the bench and the CI gate share.  Rejects
    records from a different schema version loudly rather than guessing.
    """
    out: Dict[str, List[Dict]] = {"iteration": [], "summary": []}
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            schema = rec.get("schema")
            if schema != METRICS_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{lineno}: metrics schema {schema!r} != "
                    f"supported {METRICS_SCHEMA_VERSION}"
                )
            kind = rec.get("record")
            if kind not in out:
                raise ValueError(
                    f"{path}:{lineno}: unknown record type {kind!r}"
                )
            out[kind].append(rec)
    return out
