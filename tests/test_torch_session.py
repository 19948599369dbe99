"""Port vs reference: coded training sessions end to end, on the CPU.

The reference ``CodedSession`` runs modes ``off``, ``coded`` and
``coded_q`` × {int8, int4, fp8} in one subprocess (``torch_reference``,
shared with ``tests/test_torch_checkpoint.py``) on the llama3-8b smoke
config in float32 with a forced edge drop at step 2.  It writes its
initial params (flat keys, ``checkpoint/store.py``) and its per-step
losses; the port's session starts from those params and must give the
same losses (1e-5: the same float32 arithmetic up to summation order).
Then the tolerances of ``tests/test_dist_train_elastic.py`` hold inside
the port: ``coded`` equals ``off`` (5e-4), and ``coded_q`` tracks it
(5e-3).

The granite-moe smoke config runs the same way in modes off, coded and
coded_q int8: losses and ``aux_loss`` within 1e-5, and the trained
params within 1e-4 of each leaf's largest change (plus two float32
spacings; over the int8 hop a 1e-3 share may differ, where a partial an
ulp off rounds to the next code).  So do the mamba2-370m and
recurrentgemma-2b smoke configs in coded_q int8 (losses and trained
params, the same tolerances).
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.configs.registry import get_smoke_config
from torch_reference import (  # noqa: F401 (few_threads: autouse)
    FIT,
    MOE_ARCH,
    MOE_RUNS,
    RECURRENT_LR,
    REPO,
    RUNS,
    SESSION,
    coded_q_steps_held,
    few_threads,
    reference_dir,
    subprocess_env,
)
from torch_reference import trained_params_off as _trained_params_off


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = reference_dir(tmp_path_factory)
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
    # pipeline parallelism is ported: the reference's checks, and a pp-2
    # session is a rank of a world
    with pytest.raises(ValueError, match="microbatches requires pp > 1"):
        CodedSession(cl, cfg, mode="coded", tp=2, microbatches=2,
                     device="cpu", verbose=False)
    with pytest.raises(RuntimeError, match="run_ranks"):
        CodedSession(cl, cfg, mode="coded", pp=2, device="cpu",
                     verbose=False)
    # tensor parallelism is ported: a tp-2 session is a rank of a world
    with pytest.raises(RuntimeError, match="run_ranks"):
        CodedSession(cl, cfg, mode="coded", tp=2, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="pins grad_compression"):
        CodedSession(cl, cfg, mode="coded_int8", grad_compression="fp8",
                     device="cpu", verbose=False)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    out = reference_dir(tmp_path_factory)
    return out, json.loads((out / "moe.json").read_text())


@pytest.mark.parametrize("run", [m + c for m, c in MOE_RUNS])
def test_moe_session_matches_reference(moe_reference, run):
    """The coded MoE step (λ inside each group's objective, the aux
    decoded with uniform weights) against the reference's, step by step
    with a forced edge drop."""
    from repro_torch.checkpoint.params import params_to_numpy

    out, ref = moe_reference
    init = dict(np.load(out / "moe_params.npz"))
    mode, comp = next((m, c) for m, c in MOE_RUNS if m + c == run)
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32")
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                     planner=planner_for_scheme("hgc", 1, 1), mode=mode,
                     grad_compression=comp, verbose=False, params=init,
                     device="cpu", **SESSION)
    steps = [s._iteration(t, **FIT) for t in range(4)]
    np.testing.assert_allclose([float(m["loss"]) for m in steps],
                               ref[run]["losses"], rtol=0, atol=1e-5)
    aux = [float(m["aux_loss"]) for m in steps if "aux_loss" in m]
    assert len(aux) == len(ref[run]["aux"]) == (0 if mode == "off" else 4)
    np.testing.assert_allclose(aux, ref[run]["aux"], rtol=0, atol=1e-5)
    off, total = _trained_params_off(
        params_to_numpy(s.params), dict(np.load(out / f"moe_{run}.npz")),
        init)
    assert off <= (1e-3 * total if comp else 0), (off, total)


@pytest.mark.parametrize("arch", list(RECURRENT_LR))
def test_recurrent_session_matches_reference(tmp_path_factory, arch):
    """The SSD and RG-LRU layers through the coded_q int8 step (their
    gradients, the int8 hop, the decode) against the reference's, one
    step at a time: each loss, and the params after each step, as long
    as the reference's stay finite.  The reference's smoke mamba2 goes
    NaN at its third step (its SSD's exp overflows in the masked
    triangle, ROADMAP.md §3); the port's masked segsum keeps every step
    finite."""
    held = coded_q_steps_held(reference_dir(tmp_path_factory), arch)
    assert held >= 1  # at least the first step is held
    if arch != "mamba2-370m":
        assert held == 4


@pytest.mark.parametrize("codec", ["int4", "fp8"])
def test_train_cli_smoke_on_cpu(tmp_path, codec):
    out = tmp_path / "m.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--dist", "coded_q", "--grad-compression", codec,
         "--steps", "3", "--seq-len", "16", "--log-every", "1",
         "--cluster", "hetero", "--replan-every", "2", "--force-drop-edge",
         "1", "--force-drop-step", "1", "--metrics-out", str(out)],
        cwd=REPO, env=subprocess_env(),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "one-card mesh (pod=2 × data=4) on cpu" in r.stdout
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
