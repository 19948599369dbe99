"""Port vs reference: coded training sessions end to end, on the CPU.

One subprocess runs the reference ``CodedSession`` for modes ``off``,
``coded`` and ``coded_q`` × {int8, int4, fp8} (the coded modes on an
8-device host mesh: ``XLA_FLAGS`` must be set before jax is imported,
and a pytest worker may already hold jax), on the llama3-8b smoke config
in float32 with a forced edge drop at step 2.  It writes its initial
params (flat keys, ``checkpoint/store.py``) and its per-step losses; the
port's session starts from those params and must give the same losses
(1e-5: the same float32 arithmetic up to summation order).  Then the
tolerances of ``tests/test_dist_train_elastic.py`` hold inside the port:
``coded`` equals ``off`` (5e-4), and ``coded_q`` tracks it (5e-3).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.configs.registry import get_smoke_config

REPO = Path(__file__).resolve().parent.parent
RUNS = [("off", ""), ("coded", ""), ("coded_q", "int8"), ("coded_q", "int4"),
        ("coded_q", "fp8")]
SESSION = dict(seq_len=16, optimizer="sgd", lr=0.05, total_steps=4, seed=0)
FIT = dict(force_drop_edge=1, force_drop_step=2)

_REFERENCE = """
import dataclasses, json, sys
import numpy as np
from repro.api import CodedCluster, CodedSession, planner_for_scheme
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config
out, runs, kw, fit = sys.argv[1], *map(json.loads, sys.argv[2:5])
cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
losses = {}
for mode, comp in runs:
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                     planner=planner_for_scheme("hgc", 1, 1), mode=mode,
                     grad_compression=comp, verbose=False, **kw)
    if not losses:
        np.savez(out + "/params.npz",
                 **{k: np.asarray(v) for k, v in _flatten(s.params).items()})
    losses[mode + comp] = s.fit(4, **fit)["losses"]
json.dump(losses, open(out + "/losses.json", "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_session")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out), json.dumps(RUNS),
         json.dumps(SESSION), json.dumps(FIT)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return (dict(np.load(out / "params.npz")),
            json.loads((out / "losses.json").read_text()))


def _port_losses(params, mode, comp):
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                     planner=planner_for_scheme("hgc", 1, 1), mode=mode,
                     grad_compression=comp, verbose=False, params=params,
                     device="cpu", **SESSION)
    report = s.fit(4, **FIT)
    assert report["jit_cache_entries"] == -1 and report["dist"] == mode
    return report["losses"]


@pytest.fixture(scope="module")
def port(reference):
    params, _ = reference
    return {mode + comp: _port_losses(params, mode, comp)
            for mode, comp in RUNS}


@pytest.mark.parametrize("run", [m + c for m, c in RUNS])
def test_session_losses_match_reference(reference, port, run):
    _, ref_losses = reference
    assert len(port[run]) == 4
    np.testing.assert_allclose(port[run], ref_losses[run], rtol=0, atol=1e-5)


def test_coded_equals_off_and_coded_q_tracks_it(port):
    assert abs(port["off"][0] - port["coded"][0]) < 1e-5
    np.testing.assert_allclose(port["coded"], port["off"], rtol=0, atol=5e-4)
    for codec in ("int8", "int4", "fp8"):
        np.testing.assert_allclose(port["coded_q" + codec], port["off"],
                                   rtol=0, atol=5e-3)


def test_session_options_not_ported_raise():
    cfg = get_smoke_config("llama3-8b")
    cl = CodedCluster.homogeneous(2, 4)
    for kw in (dict(tp=2), dict(pp=2), dict(checkpoint_dir="x"),
               dict(resume=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            CodedSession(cl, cfg, mode="coded", device="cpu", verbose=False,
                         **kw)
    s = CodedSession(cl, cfg, mode="coded", device="cpu", verbose=False,
                     seq_len=8)
    for call in (s.shrink, s.save_checkpoint, lambda: s.eval_step({}),
                 lambda: s.generate([[1]], 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    with pytest.raises(ValueError, match="pins grad_compression"):
        CodedSession(cl, cfg, mode="coded_int8", grad_compression="fp8",
                     device="cpu", verbose=False)


@pytest.mark.parametrize("codec", ["int4", "fp8"])
def test_train_cli_smoke_on_cpu(tmp_path, codec):
    out = tmp_path / "m.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--dist", "coded_q", "--grad-compression", codec,
         "--steps", "3", "--seq-len", "16", "--log-every", "1",
         "--cluster", "hetero", "--replan-every", "2", "--force-drop-edge",
         "1", "--force-drop-step", "1", "--metrics-out", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "one-card mesh (pod=2 × data=4) on cpu" in r.stdout
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
