"""The train CLI at ``--pp 2`` (ranks it spawns itself, gloo on the CPU):
across a forced straggler drop and a JNCSS replan (printing ``pipeline
stages 2``), composed with ``--tp 2 --seq-shard``, a degree the config's
layer groups do not divide, and ``--dist off``."""
import json
import os
import subprocess
import sys

import numpy as np

from repro_torch.launch import train


def _cli(args, timeout=400):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--smoke", "--device", "cpu"] + args,
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_train_cli_pp2_across_drop_and_replan():
    """The port's counterpart of the reference's
    ``test_pp_zero_recompile_across_drop_and_replan``: the pipeline runs
    through a forced straggler drop and a JNCSS replan (the port's step
    is eager: its jit cache count stays -1, a warning)."""
    r = _cli(["--arch", "llama3-8b", "--scheme", "hgc_jncss", "--cluster",
              "hetero", "--n-edges", "2", "--n-workers", "4", "--pp", "2",
              "--steps", "4", "--seq-len", "16", "--log-every", "1",
              "--optimizer", "sgd", "--lr", "0.05", "--replan-every", "3",
              "--force-drop-edge", "1", "--force-drop-step", "2",
              "--dist", "coded", "--expect-zero-recompile"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "pipeline stages 2" in r.stdout
    assert "jit cache entries: -1" in r.stdout
    losses = [float(line.split("loss ")[1].split()[0])
              for line in r.stdout.splitlines() if "] step " in line]
    assert len(losses) == 4 and np.isfinite(losses).all()


def test_train_cli_pp_rejects_bad_degree():
    r = _cli(["--arch", "granite-8b", "--steps", "1", "--scheme", "hgc",
              "--s-e", "0", "--s-w", "0", "--dist", "coded", "--n-edges",
              "2", "--n-workers", "2", "--pp", "2"])
    assert r.returncode != 0
    assert "divisib" in (r.stderr + r.stdout)


def test_train_cli_pp_requires_dist_mode():
    r = _cli(["--arch", "llama3-8b", "--steps", "1", "--dist", "off",
              "--pp", "2"])
    assert r.returncode != 0
    assert "requires a --dist mode" in (r.stderr + r.stdout)


def test_train_cli_pp2_tp2_seq_shard(tmp_path):
    """``--pp 2 --tp 2 --seq-shard``: 4 ranks, the losses of ``--tp 2
    --seq-shard`` (the pipeline moves where the layers run, not their
    values; f32 sums in another order)."""
    outs = []
    for extra in ([], ["--pp", "2"]):
        out = tmp_path / f"m{len(outs)}.json"
        train.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--seq-len", "16", "--dist", "coded_q", "--tp", "2",
                    "--seq-shard", "--optimizer", "sgd", "--lr", "0.05",
                    "--scheme", "hgc", "--metrics-out", str(out)] + extra)
        outs.append(json.load(open(out))["losses"])
    assert len(outs[1]) == 3 and np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=0)
