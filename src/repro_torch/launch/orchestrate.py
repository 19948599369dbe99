"""Supervised coded training — the orchestrator CLI of the port.

The reference's ``repro.launch.orchestrate`` plus ``--device`` (the card
unless ``--device cpu``).  Runs a :class:`~repro_torch.api.CodedSession`
under the control plane of
:mod:`repro_torch.orchestrator`: a pool of real worker processes, heartbeat
liveness, seeded failure injection, and event-driven replanning that
closes the paper's fit-replan loop from MEASURED runtimes
(``CodedCluster.from_observations``).  The thin shell over
:class:`~repro_torch.orchestrator.controller.Orchestrator` — all policy
lives in the library.

Examples::

    # a seeded kill + slow-edge episode, metrics to JSONL
    python -m repro_torch.launch.orchestrate --smoke --steps 12 \
        --inject "kill:w0.1@3,slow:e1@5x2:4.0" \
        --metrics-out /tmp/orch.jsonl --min-replans 1

    # random-but-reproducible soak on the CPU, worker threads
    python -m repro_torch.launch.orchestrate --smoke --steps 20 \
        --inject seeded:4 --seed 7 --device cpu --backend thread

``--expect-zero-recompile`` is accepted as in the reference: the port's
step is eager, so the summary's ``jit_cache_entries`` is −1 and the
check is skipped with a warning.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.orchestrator import (HeartbeatConfig, InjectionSchedule,
                                MetricsSink, Orchestrator,
                                OrchestratorConfig)


def _parse_schedule(spec: str, topo, steps: int, seed: int):
    """``--inject`` accepts the spec grammar or ``seeded[:n_events]``."""
    if not spec:
        return InjectionSchedule()
    if spec == "seeded" or spec.startswith("seeded:"):
        n = int(spec.split(":", 1)[1]) if ":" in spec else 3
        return InjectionSchedule.seeded(seed, topo, steps, n_events=n)
    return InjectionSchedule.parse(spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="shrunken config for CI-sized runs")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--part-batch", type=int, default=1)
    ap.add_argument("--scheme", default="hgc",
                    help="planner scheme (see docs/planners.md)")
    ap.add_argument("--planner", default="",
                    help="override planner by name (jncss | fixed | "
                         "uniform | grouped | comm_budget); empty: "
                         "derive from --scheme")
    ap.add_argument("--s-e", type=int, default=1)
    ap.add_argument("--s-w", type=int, default=1)
    ap.add_argument("--n-edges", type=int, default=3)
    ap.add_argument("--n-workers", type=int, default=3)
    ap.add_argument("--cluster", default="hetero",
                    choices=["homogeneous", "hetero"])
    ap.add_argument("--dist", default="off",
                    choices=["off", "coded", "coded_int8", "coded_q"],
                    help="aggregation mode of the underlying session "
                         "(coded_q: int8 codec default)")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    # ---- control plane ------------------------------------------------
    ap.add_argument("--inject", default="",
                    help="failure schedule: 'kill:w0.1@3,slow:e1@5x2:4' "
                         "(kind:target@step[xduration][:factor]) or "
                         "'seeded[:n_events]' for a reproducible "
                         "random schedule")
    ap.add_argument("--heartbeat-ms", type=float, default=0.0,
                    help="heartbeat interval on the virtual clock "
                         "(0: derive from the plan's expected "
                         "iteration time)")
    ap.add_argument("--heartbeat-timeout-ms", type=float, default=0.0,
                    help="miss deadline (0: 2.5x the interval)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "process", "thread"],
                    help="worker pool backend (auto: processes when "
                         "the runner has >= 2 cores)")
    ap.add_argument("--replan-cooldown", type=int, default=2)
    ap.add_argument("--metrics-out", default="",
                    help="per-iteration metrics JSONL path")
    ap.add_argument("--expect-zero-recompile", action="store_true",
                    help="the port's step is eager: warns that there is "
                         "nothing to count")
    ap.add_argument("--min-replans", type=int, default=0,
                    help="exit 1 unless at least this many successful "
                         "replans happened")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    ctor = (CodedCluster.hetero if args.cluster == "hetero"
            else CodedCluster.homogeneous)
    planner = (args.planner if args.planner
               else planner_for_scheme(args.scheme, args.s_e, args.s_w))
    try:
        session = CodedSession(
            ctor(args.n_edges, args.n_workers), cfg,
            planner=planner, mode=args.dist, seq_len=args.seq_len,
            part_batch=args.part_batch, lr=args.lr,
            total_steps=args.steps, seed=args.seed,
            verbose=args.verbose, device=args.device,
        )
    except ValueError as e:
        raise SystemExit(f"[orchestrate] {e}")

    schedule = _parse_schedule(args.inject, session.cluster.topo,
                               args.steps, args.seed)
    hb = None
    if args.heartbeat_ms > 0:
        hb = HeartbeatConfig(
            interval_ms=args.heartbeat_ms,
            timeout_ms=(args.heartbeat_timeout_ms
                        or 2.5 * args.heartbeat_ms),
        )
    orch = Orchestrator(
        session,
        OrchestratorConfig(
            steps=args.steps, backend=args.backend, heartbeat=hb,
            replan_cooldown=args.replan_cooldown, verbose=args.verbose,
        ),
        schedule=schedule,
        metrics=MetricsSink(args.metrics_out or None),
    )
    summary = orch.run_episode()
    print(json.dumps(summary, indent=1))

    failed = False
    if args.expect_zero_recompile:
        entries = summary["jit_cache_entries"]
        if entries == -1:
            print("[orchestrate] WARNING: jit cache size unavailable "
                  "(the port's step is eager); zero-recompile check "
                  "skipped",
                  file=sys.stderr)
        elif entries != 1:
            print(f"[orchestrate] FAIL: expected exactly 1 compiled "
                  f"train executable, found {entries}", file=sys.stderr)
            failed = True
    if summary["counters"]["replans"] < args.min_replans:
        print(f"[orchestrate] FAIL: expected >= {args.min_replans} "
              f"successful replans, got "
              f"{summary['counters']['replans']}", file=sys.stderr)
        failed = True
    if failed:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
