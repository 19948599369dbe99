"""Run one benchmark cell of the port and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``.  The run
sets up (kernels built once into the checkout's ``build/``, weights made
on the card from the seed, every shape of the cell warmed), measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints, as its last lines, each number compared
beside its limit on standard error and one JSON object on standard
output.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones.  A run that finds no CUDA card, or fewer cards
than the cell asks for, exits with 2 and prints no result.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the harness's modules are imported as ``portbench.*`` only
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Epoch seconds at which this process started (the kernel's record),
    or the first line of this script where that is not readable."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + start
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def device_info(torch, count: int) -> dict:
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else ""
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = spec.driver(cell).run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda"),
                                torch.cuda.synchronize, t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the reporting process loaded {bad}",
              file=sys.stderr)
        return 3
    return report(cell, bool(args.trace), out,
                  device_info(torch, cell.chips))


def report(cell, traced: bool, out, device: dict) -> int:
    """Print the checks and the result line of a finished run."""
    from portbench import check, profiling, spec

    rec = out["records"]
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    if traced and "trace" in rec:
        t = rec["trace"]
        device["busy_s"] = profiling.union_s(t["device"])
        device["window_s"] = t["window_s"]
    checks = out["checks"]
    print(f"portbench: {cell.name}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out.get("times", {}).items()),
        file=sys.stderr)
    result = {"correct": check.correct(checks) and out["failed"] == 0
              and out["attempted"] > 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if traced and "trace" in rec:
        result["breakdown"] = profiling.breakdown(rec["trace"])
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(result)))
    return 0


def _finite(x):
    """``x`` with every non-finite float as null (JSON has no NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
