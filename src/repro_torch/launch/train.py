"""Coded training CLI of the port.

PyTorch counterpart of ``repro.launch.train``, with the same flags plus
``--device``: flags → ``CodedCluster`` + planner + ``CodedSession`` →
``fit()``.  The ``--dist`` modes are the session's:

  * ``off`` — single-host reference loop (λ in the batch weights),
  * ``coded`` — the (pod, data) mesh on one card, two-stage coded decode
    (eqs. 25/27), λ a runtime operand,
  * ``coded_int8`` / ``coded_q`` — same, with the quantized + error-
    feedback edge→master hop (``--grad-compression int8|int4|fp8``),
    decoded by the fused dequant combine kernels.

Checkpoints are atomic and in the reference's layout: a run killed
with ``--stop-after`` and rerun with ``--resume`` and the SAME
``--steps`` (``total_steps`` sets the LR schedule) reproduces the
uninterrupted run's losses bit for bit.  Runs on the card unless
``--device cpu`` is given.

``--tp N`` (or ``--model-shards N``) with a ``--dist`` mode trains with
Megatron tensor parallelism over N ranks that the CLI spawns
(``dist.launch.run_ranks``), every (pod, data) group in turn on each
rank; under a launcher that sets ``RANK``/``WORLD_SIZE`` (torchrun) it
joins that world instead, whose size may also give the pods or the
workers ranks of their own (``DistMesh.for_world``).  Rank 0 prints,
writes ``--metrics-out`` and the checkpoints (the full arrays, which
restore at any degree).  ``--seq-shard`` adds sequence
parallelism to ``--tp`` (the sequence length must divide tp).  ``--pp
N`` (with or without ``--tp``) adds a leading "stage" axis of pipeline
parallelism: the CLI spawns ``pp × tp`` ranks (or joins torchrun's
world), each stage holding its block of the layer-group stacks, each
group's rows run as ``--microbatches`` microbatches (default one per
stage).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --seq-len 16 --dist coded_q --grad-compression int4
  # kill after 2 steps, then resume to step 4
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --seq-len 16 --dist coded_q --checkpoint-dir /tmp/ck \\
      --checkpoint-every 2 --stop-after 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --seq-len 16 --dist coded_q --checkpoint-dir /tmp/ck \\
      --checkpoint-every 2 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 4 --seq-len 16 --dist coded_q --tp 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --arch granite-moe-3b-a800m --steps 4 --seq-len 16 --dist coded_q \
      --tp 2 --seq-shard
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 4 --seq-len 16 --dist coded_q --pp 2 --tp 2 --seq-shard
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch._device import resolve_device
from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist.launch import join_launcher_world, run_ranks
from repro_torch.dist.sharding import validate_pp


def main(argv=None, full_params: bool = False):
    """Run the CLI → the session's params at tp 1 and pp 1; under ``--tp
    N`` or ``--pp N``, rank 0's gathered full arrays by flat key when
    ``full_params`` is set (every rank joins the gather), else ``None``:
    at full width they are the whole model in float32."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--part-batch", type=int, default=1,
                    help="examples per dataset part per iteration")
    ap.add_argument("--scheme", default="hgc_jncss",
                    choices=["hgc", "hgc_jncss", "uncoded",
                             "hgc_grouped", "hgc_comm"],
                    help="planning strategy (docs/planners.md)")
    ap.add_argument("--s-e", type=int, default=1)
    ap.add_argument("--s-w", type=int, default=1)
    ap.add_argument("--n-edges", type=int, default=2)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--cluster", default="homogeneous",
                    choices=["homogeneous", "hetero"],
                    help="simulated cluster model (hetero: one slow edge)")
    ap.add_argument("--K", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--dist", default="off",
                    choices=["off", "coded", "coded_int8", "coded_q"],
                    help="aggregation mode: single-host reference, coded "
                         "decode on the one-card (pod, data) mesh, or "
                         "coded with the quantized + EF cross-pod hop")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="'model' mesh axis size (alias of --tp)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree: the ranks to spawn")
    ap.add_argument("--seq-shard", dest="seq_shard", action="store_const",
                    const=True, default=None,
                    help="sequence parallelism over the --tp ranks "
                         "(activations seq-sharded between the TP "
                         "collective pairs)")
    ap.add_argument("--no-seq-shard", dest="seq_shard",
                    action="store_const", const=False)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stage count (--dist modes): "
                         "a leading 'stage' axis of ranks splits the "
                         "stacked layer groups and the train step runs "
                         "a microbatched pipeline before the coded "
                         "decode.  Needs n_layers//len(block_pattern) "
                         "divisible by the stage count; composes with "
                         "--tp, --seq-shard and the quantized hop")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatch count per step (0 = one "
                         "per stage, the minimum that fills the "
                         "pipeline).  Must divide the per-group coded "
                         "batch rows (load D × --part-batch)")
    ap.add_argument("--grad-block", type=int, default=64,
                    help="quantization block on the edge→master hop")
    ap.add_argument("--grad-compression", default="",
                    choices=["", "int8", "int4", "fp8"],
                    help="cross-pod codec for --dist coded_q (default "
                         "int8)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory of the atomic checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=25,
                    help="checkpoint period in steps")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="simulate a kill: exit cleanly after N steps "
                         "without touching the LR schedule (--steps still "
                         "sets total_steps, so a later --resume run "
                         "reproduces the uninterrupted trajectory)")
    ap.add_argument("--replan-every", type=int, default=0,
                    help="re-run the planner from observed delays every N "
                         "steps")
    ap.add_argument("--force-drop-edge", type=int, default=-1,
                    help="force this edge to straggle at --force-drop-step")
    ap.add_argument("--force-drop-step", type=int, default=-1)
    ap.add_argument("--metrics-out", default="",
                    help="write per-step losses as JSON")
    ap.add_argument("--expect-zero-recompile", action="store_true",
                    help="the port's step is eager: warns that there is "
                         "nothing to count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    tp = args.tp or args.model_shards
    if args.dist == "off" and tp > 1:
        raise SystemExit("--tp requires a --dist mode")
    if args.dist == "off" and args.pp > 1:
        raise SystemExit("--pp requires a --dist mode (the pipeline runs "
                         "over the 'stage' axis of the coded step)")
    ranks = tp * max(args.pp, 1)
    if ranks > 1 and not join_launcher_world(args.device):
        resolve_device(args.device)  # no CUDA: raise here, not in a rank
        try:
            validate_pp(cfg, args.pp)  # a bad degree fails here, once
        except ValueError as e:
            raise SystemExit(f"[train] {e}")
        return run_ranks(main, ranks, args=(argv, full_params),
                         device=args.device, timeout=86400.0)[0]
    ctor = CodedCluster.hetero if args.cluster == "hetero" \
        else CodedCluster.homogeneous
    try:
        session = CodedSession(
            ctor(args.n_edges, args.n_workers), cfg,
            planner=planner_for_scheme(args.scheme, args.s_e, args.s_w),
            mode=args.dist, tp=tp, seq_shard=args.seq_shard, pp=args.pp,
            microbatches=args.microbatches, seq_len=args.seq_len,
            part_batch=args.part_batch, K=args.K, optimizer=args.optimizer,
            lr=args.lr, total_steps=args.steps, grad_block=args.grad_block,
            grad_compression=args.grad_compression, seed=args.seed,
            scheme=args.scheme, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            log_every=args.log_every, device=args.device,
        )
    except ValueError as e:
        raise SystemExit(f"[train] {e}")
    report = session.fit(
        args.steps, replan_every=args.replan_every,
        force_drop_edge=args.force_drop_edge,
        force_drop_step=args.force_drop_step, stop_after=args.stop_after,
    )
    full = session.full_params() if full_params and ranks > 1 else None
    if session.rank != 0:
        return None
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.expect_zero_recompile and report["jit_cache_entries"] == -1:
        # the reference's own "cannot tell" branch
        print("[train] WARNING: jit cache size unavailable (the port's "
              "step is eager); zero-recompile check skipped",
              file=sys.stderr)
    return full if ranks > 1 else session.params


if __name__ == "__main__":
    main()
