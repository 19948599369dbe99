"""Multi-pod dry-run CLI of the port.

For every (architecture × input shape × mesh) cell: one rank's step run
on the ``meta`` device under the op counter → memory, FLOPs, bytes,
collectives and the roofline, on the 16×16 single-pod layout and the
2×16×16 multi-pod one (``launch.mesh``).  The machinery lives in
:mod:`repro_torch.api.aot`; this module is the CLI around
:func:`~repro_torch.api.aot.run_cell`.  It needs no devices and no
``XLA_FLAGS``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun
    python -m repro_torch.launch.dryrun --all --multi-pod \\
        --out results/dryrun
    python -m repro_torch.launch.dryrun --arch qwen2-vl-2b --shape train_4k \\
        --mode dp_only
"""
import argparse
import json
import os

from repro_torch.api.aot import run_cell
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--sharded-accum", action="store_true")
    ap.add_argument("--kv-repeat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "save_block_outputs"])
    ap.add_argument("--mode", default="2d", choices=["2d", "dp_only"])
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence parallelism on the 'model' axis: the "
                         "activations between the TP collective pairs "
                         "hold 1/tp of the sequence")
    ap.add_argument("--moe-ep", default="model", choices=["model", "data"])
    ap.add_argument("--microbatch", type=int, default=32)
    ap.add_argument("--out", default="")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (perf variants)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    results = []
    for a, s in cells:
        rec = run_cell(
            a, s, multi_pod=args.multi_pod, fsdp=not args.no_fsdp,
            microbatch=args.microbatch, remat=not args.no_remat,
            flash=args.flash, sharded_accum=args.sharded_accum,
            kv_repeat=args.kv_repeat, remat_policy=args.remat_policy,
            mode=args.mode, moe_ep_axis=args.moe_ep,
            seq_shard=args.seq_shard,
        )
        results.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            tag = "multi" if args.multi_pod else "single"
            if args.tag:
                tag += "__" + args.tag
            path = os.path.join(args.out, f"{a}__{s}__{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"of {len(results)} cells")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
