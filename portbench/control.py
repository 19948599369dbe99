"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--faults]

For each seed, in one process: with ``--program`` the program's reading
of every number compared (a training cell's set-up and first steps; a
serving cell's batches through one whole cycle of the mix), with
``--control`` the control's (the reference computed in fp8 in the
program's place), and with ``--faults`` the faults the cell can have,
planted where the work is produced (training: a step that leaves half
of its batch out and takes the mean over the rest; a state left
unchanged reads 1 by the change's measure and needs no run.  Serving:
one served token altered).  Every reading is against the float32
reference; one JSON line a seed.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]


def _free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(cell, seed, device, program, control, faults):
    from portbench import check, spec
    from portbench.reference import train as ref_train

    m, tr, steps = cell.model, cell.traffic, cell.traffic["ref_steps"]
    out = {}
    prog = None
    if program:
        session, step, prog = spec.driver(cell).start(cell, seed, device)
        session = step = None
        _free()
    want = ref_train.run(m, tr, seed, steps, device)

    def values(got):
        out = {k: v["value"] for k, v in
               check.training(got, want, cell.limits).items()}
        for what in ("grad_norms", "change"):  # the three worst leaves
            gaps = check.leaf_gaps(got, want, what)
            out[f"worst_{what}"] = sorted(gaps.items(),
                                          key=lambda kv: -kv[1])[:3]
        out["losses"] = got["losses"]
        return out

    out["reference_losses"] = want["losses"]
    if prog is not None:
        out["program"] = values(prog)
    if control:
        out["control_fp8"] = values(ref_train.run(m, tr, seed, steps, device,
                                                  quant="fp8"))
    if faults:
        out["fault_half_batch"] = values(ref_train.run(
            m, tr, seed, steps, device, fault="half_batch"))
    return out


def serve_readings(cell, seed, device, program, control, faults):
    from portbench import spec

    drv = spec.driver(cell)
    srv = drv.Server(cell, seed, device)
    srv.warm()
    done = srv.window(0, batches=len(cell.traffic["cycle"]))
    srv = None
    _free()
    out = {}
    if program:
        out["program"] = {"logit_gap": max(drv.reference_gaps(
            cell, seed, done, device))}
    if control:
        out["control_fp8"] = {"logit_gap": max(drv.reference_gaps(
            cell, seed, done, device, control=True))}
    if faults:
        d = done[0]
        d["tokens"] = d["tokens"].copy()
        d["tokens"][:, -1] = (d["tokens"][:, -1] + 1) % cell.model["vocab"]
        out["fault_altered_token"] = {"logit_gap": max(drv.reference_gaps(
            cell, seed, done[:1], device))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(ROOT, args.workload)
    read = train_readings if cell.traffic["kind"] == "train" \
        else serve_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        out = read(cell, seed, torch.device("cuda"), args.program,
                   args.control, args.faults)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
