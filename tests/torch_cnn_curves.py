"""The CNN's loss and accuracy curves in both packages, on the CPU.

Runs ``simulate_training`` of one scheme on the CIFAR stand-in in the
reference (``repro.sim.simulator``) and in the port
(``repro_torch.sim.simulator``, ``device="cpu"``) from the same initial
weights (the reference's seeded ones, carried over by
``classic_params_from_reference``), at the evaluation's FULL settings by
default (Figs. 5/6: seed 7, K 40, 8000 samples, batch 32 per part, 1000
evaluation samples, lr 0.05, 100 iterations, an evaluation every 10),
and prints both curves, their largest differences and each package's
wall time on this CPU.  Not a test (it takes minutes); run it as

    PYTHONPATH=src python tests/torch_cnn_curves.py [--iters N] [--out f.json]

``--package ref`` or ``--package port`` runs one side alone and writes
its curves to ``--out``; ``--compare a.json b.json`` compares two such
files.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _settings(args):
    return dict(dataset="cifar", K=40, iters=args.iters, lr=0.05,
                batch_per_part=32, eval_every=10, n_data=8000,
                n_eval=1000, seed=args.seed)


def run_ref(args):
    from repro.core.runtime_model import paper_cluster
    from repro.sim import simulator

    t0 = time.perf_counter()
    tr = simulator.simulate_training(args.scheme, paper_cluster("cifar"),
                                     **_settings(args))
    return tr, time.perf_counter() - t0


def run_port(args):
    from repro.sim import simulator as ref_sim
    from repro_torch.checkpoint.params import classic_params_from_reference
    from repro_torch.core.runtime_model import paper_cluster
    from repro_torch.sim import simulator

    init = classic_params_from_reference(
        ref_sim._make_model("cifar", args.seed)[0], "cpu")
    t0 = time.perf_counter()
    tr = simulator.simulate_training(args.scheme, paper_cluster("cifar"),
                                     device="cpu", init_params=init,
                                     **_settings(args))
    return tr, time.perf_counter() - t0


def _record(package, tr, seconds):
    return dict(package=package, seconds=seconds,
                losses=np.asarray(tr.losses).tolist(),
                accuracies=np.asarray(tr.accuracies).tolist(),
                eval_iters=np.asarray(tr.eval_iters).tolist())


def compare(ref, port):
    lr, lp = np.asarray(ref["losses"]), np.asarray(port["losses"])
    ar, ap = np.asarray(ref["accuracies"]), np.asarray(port["accuracies"])
    print(f"eval iterations {ref['eval_iters']}")
    print(f"accuracy, reference {ar.tolist()}")
    print(f"accuracy, port      {ap.tolist()}")
    print(f"max |accuracy difference| {np.abs(ar - ap).max():.4f}")
    rel = np.abs(lr - lp) / np.abs(lr)
    for t in range(0, len(lr), 10):
        print(f"iteration {t:3d}: |aggregate| reference {lr[t]:.6g}, port "
              f"{lp[t]:.6g}, relative difference {rel[t]:.3g}")
    print(f"|aggregate| at the last iteration: reference {lr[-1]:.6g}, "
          f"port {lp[-1]:.6g}")
    print(f"relative loss difference: first 10 iterations max "
          f"{rel[:10].max():.3g}, all max {rel.max():.3g}")
    print(f"wall time on this CPU: reference {ref['seconds']:.1f} s, port "
          f"{port['seconds']:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scheme", default="hgc")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--package", choices=("both", "ref", "port"),
                    default="both")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        ref, port = (a, b) if a["package"] == "ref" else (b, a)
        compare(ref, port)
        return
    recs = {}
    for package, fn in (("ref", run_ref), ("port", run_port)):
        if args.package in ("both", package):
            recs[package] = _record(package, *fn(args))
            print(f"{package}: {recs[package]['seconds']:.1f} s, accuracies "
                  f"{recs[package]['accuracies']}", flush=True)
    if args.out:
        rec = recs[args.package] if args.package != "both" else recs
        with open(args.out, "w") as f:
            json.dump(rec, f)
    if len(recs) == 2:
        compare(recs["ref"], recs["port"])


if __name__ == "__main__":
    main()
