"""The reference sessions the port's session tests are held against.

One subprocess runs the reference ``CodedSession`` (the coded modes on an
8-device host mesh: ``XLA_FLAGS`` must be set before jax is imported,
and a pytest worker may already hold jax) on the llama3-8b smoke config
in float32, and writes into one directory:

  * ``params.npz`` — the initial params by flat key (every session here
    starts from them: they are ``init_params(PRNGKey(0), cfg)``),
  * ``losses.json`` — the losses of each run, by name:
    ``off``/``coded``/``coded_qint8``/… (4 sgd steps, edge 1 dropped at
    step 2); ``killed`` and ``resumed`` (adamw coded_q int8 with a
    checkpoint at step 2, killed there, resumed from a copy of the
    directory to step 4); ``shrink`` (coded_int8 on a 3 × 2 cluster, 3
    steps, edge 1 shrunk away, on to step 6),
  * ``ck/`` — the killed run's checkpoint directory (step 2),
  * ``shrink_residual.npz`` — the first residual leaf before and after
    the shrink,
  * ``serve.npz`` / ``serve.json`` — an eval batch with its
    ``eval_step`` metrics, and prompts with their greedy f32 tokens
    from a serve-only session,
  * ``moe_params.npz``, ``moe_<run>.npz``, ``moe.json`` — the
    granite-moe smoke config in float32 (the same session settings, one
    step at a time with edge 1 dropped at step 2) in modes off, coded and
    coded_q int8: the initial params, each run's trained params, and each
    step's loss and (coded modes) ``aux_loss``,
  * ``rec_<arch>_init.npz``, ``rec_<arch>_<step>.npz``,
    ``recurrent.json`` — the mamba2-370m, recurrentgemma-2b and
    qwen2-vl-2b smoke configs in float32, coded_q int8 for 4 steps, one
    ``_iteration`` at a time, with edge 1 dropped at step 2 (mamba2 at
    lr 1e-3): the initial params, the params after each step and each
    step's loss.  The reference's mamba2 gradients can overflow to NaN
    (its SSD exponentiates the masked triangle, ROADMAP.md §3), after
    which its params and losses are NaN.

Test files in several pytest-xdist workers share one run: the first to
take the lock runs it, the others wait for its ``done`` marker.
"""
import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

RUNS = [("off", ""), ("coded", ""), ("coded_q", "int8"), ("coded_q", "int4"),
        ("coded_q", "fp8")]
SESSION = dict(seq_len=16, optimizer="sgd", lr=0.05, total_steps=4, seed=0)
FIT = dict(force_drop_edge=1, force_drop_step=2)
# the checkpointed adamw run (killed after step 2, resumed to step 4)
CKPT = dict(seq_len=16, optimizer="adamw", lr=0.01, total_steps=4, seed=0,
            checkpoint_every=2, keep_checkpoints=1)
# tests/test_api_session.py's shrink run, in float32
SHRINK = dict(seq_len=16, optimizer="sgd", lr=0.05, total_steps=6, seed=0)
GEN = 6
MOE_ARCH = "granite-moe-3b-a800m"
MOE_RUNS = [("off", ""), ("coded", ""), ("coded_q", "int8")]
#: the recurrent archs' coded_q int8 runs: arch → sgd learning rate
RECURRENT_LR = {"mamba2-370m": 1e-3, "recurrentgemma-2b": SESSION["lr"]}
#: the archs run one coded_q int8 step at a time: the recurrent ones and
#: qwen2-vl (M-RoPE over its default positions)
CODED_Q_LR = {**RECURRENT_LR, "qwen2-vl-2b": SESSION["lr"]}
#: intra-op threads for the port's tiny models: with several pytest-xdist
#: workers, more threads than that per worker only contend for the cores
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Import into a test module to run its torch work on ``THREADS``
    threads (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def subprocess_env(**extra) -> dict:
    """The environment of a port subprocess: ``src`` on the path and
    ``THREADS`` OpenMP threads."""
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                OMP_NUM_THREADS=str(THREADS), **extra)

_SCRIPT = """
import dataclasses, json, shutil, sys
import jax
import numpy as np
from repro.api import CodedCluster, CodedSession, planner_for_scheme
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config
(out, runs, kw, fit, ck, shrink, gen, moe_arch, moe_runs,
 recurrent_lr) = sys.argv[1], *map(json.loads, sys.argv[2:11])
cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")


def flat(params):
    return {k: np.asarray(v) for k, v in _flatten(params).items()}


def session(cluster, mode, comp, planner=None, model=None, **extra):
    return CodedSession(cluster, model or cfg,
                        planner=planner or planner_for_scheme("hgc", 1, 1),
                        mode=mode, grad_compression=comp, verbose=False,
                        **extra)


losses = {}
for mode, comp in runs:
    s = session(CodedCluster.homogeneous(2, 4), mode, comp, **kw)
    if not losses:
        np.savez(out + "/params.npz", **flat(s.params))
    losses[mode + comp] = s.fit(4, **fit)["losses"]

s = session(CodedCluster.homogeneous(2, 4), "coded_q", "int8",
            checkpoint_dir=out + "/ck", **ck)
losses["killed"] = s.fit(4, stop_after=2, **fit)["losses"]
shutil.copytree(out + "/ck", out + "/ck_resumed")
s = session(CodedCluster.homogeneous(2, 4), "coded_q", "int8",
            checkpoint_dir=out + "/ck_resumed", resume=True, **ck)
losses["resumed"] = s.fit(4, **fit)["losses"]

s = session(CodedCluster.hetero(3, 2), "coded_int8", "", planner="fixed",
            **shrink)
s.fit(3)
before = np.asarray(jax.tree.leaves(s.residual)[0])
s.shrink(dead_edges=[1])
after = np.asarray(jax.tree.leaves(s.residual)[0])
s.fit(6)
losses["shrink"] = s.losses
np.savez(out + "/shrink_residual.npz", before=before, after=after)

rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
         "weights": rng.random((2, 16)).astype(np.float32)}
prompts = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
s = CodedSession(None, cfg, verbose=False)
serve = {"eval": s.eval_step(batch),
         "tokens": np.asarray(s.generate(prompts, gen)).tolist()}
np.savez(out + "/serve.npz", prompts=prompts, **batch)
json.dump(serve, open(out + "/serve.json", "w"))

moe_cfg = dataclasses.replace(get_smoke_config(moe_arch), dtype="float32")
moe = {}
for mode, comp in moe_runs:
    s = session(CodedCluster.homogeneous(2, 4), mode, comp, model=moe_cfg,
                **kw)
    if not moe:
        np.savez(out + "/moe_params.npz", **flat(s.params))
    steps = [s._iteration(t, **fit) for t in range(4)]
    moe[mode + comp] = {
        "losses": [float(m["loss"]) for m in steps],
        "aux": [float(m["aux_loss"]) for m in steps if "aux_loss" in m]}
    np.savez(out + f"/moe_{mode + comp}.npz", **flat(s.params))
json.dump(moe, open(out + "/moe.json", "w"))

recurrent = {}
for arch, lr in recurrent_lr.items():
    rcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    s = session(CodedCluster.homogeneous(2, 4), "coded_q", "int8",
                model=rcfg, **dict(kw, lr=lr))
    np.savez(out + f"/rec_{arch}_init.npz", **flat(s.params))
    recurrent[arch] = []
    for t in range(4):
        recurrent[arch].append(float(s._iteration(t, **fit)["loss"]))
        np.savez(out + f"/rec_{arch}_{t}.npz", **flat(s.params))
json.dump(recurrent, open(out + "/recurrent.json", "w"))
json.dump(losses, open(out + "/losses.json", "w"))
"""


def _run(out: Path) -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    args = [json.dumps(x) for x in (RUNS, SESSION, FIT, CKPT, SHRINK, GEN,
                                    MOE_ARCH, MOE_RUNS, CODED_Q_LR)]
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out), *args],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError("reference sessions failed:\n"
                           + r.stdout[-2000:] + r.stderr[-2000:])


class RecordingOptimizer:
    """An optimizer that keeps the decoded gradient and updates nothing."""

    def __init__(self):
        self.grads = None

    def apply_(self, grads, state, params, lr, weight_decay=0.0):
        self.grads = [g.clone() for g in grads]


def trained_params_off(got, want, init):
    """Trained values off by more than 1e-4 of their leaf's largest
    change plus two float32 spacings → (count, of all)."""
    import numpy as np

    assert got.keys() == want.keys()
    off = total = 0
    for key, w in want.items():
        tol = (1e-4 * np.abs(w - init[key]).max()
               + 2 * np.spacing(np.abs(w)))
        off += int((np.abs(got[key] - w) > tol).sum())
        total += w.size
    return off, total


def coded_q_steps_held(out: Path, arch: str) -> int:
    """The port's coded_q int8 session on ``arch``'s float32 smoke config
    from the reference run's initial params, one ``_iteration`` at a
    time against the reference's (:data:`CODED_Q_LR`): each loss within
    1e-5 and the params after each step within :func:`trained_params_off`
    (a 1e-3 share may differ over the int8 hop), as long as the
    reference's stay finite; every port loss finite.  → the steps held."""
    import dataclasses

    import numpy as np

    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
    from repro_torch.checkpoint.params import params_to_numpy
    from repro_torch.configs.registry import get_smoke_config

    init = dict(np.load(out / f"rec_{arch}_init.npz"))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                     planner=planner_for_scheme("hgc", 1, 1), mode="coded_q",
                     grad_compression="int8", verbose=False, params=init,
                     device="cpu", **dict(SESSION, lr=CODED_Q_LR[arch]))
    want = json.loads((out / "recurrent.json").read_text())[arch]
    held = 0
    for t in range(4):
        loss = float(s._iteration(t, **FIT)["loss"])
        assert np.isfinite(loss), (t, loss)
        ref_params = dict(np.load(out / f"rec_{arch}_{t}.npz"))
        if not np.isfinite(want[t]):
            continue
        np.testing.assert_allclose(loss, want[t], rtol=0, atol=1e-5)
        if all(np.isfinite(v).all() for v in ref_params.values()):
            off, total = trained_params_off(params_to_numpy(s.params),
                                            ref_params, init)
            assert off <= 1e-3 * total, (t, off, total)
            held += 1
    return held


def reference_dir(tmp_path_factory) -> Path:
    """The directory of the reference run, made once per test session
    (once across the pytest-xdist workers of one run)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    out = base.parent / f"torch_reference_{uid}" if uid else \
        base / "torch_reference"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (out / "failed").exists():
                raise RuntimeError((out / "failed").read_text())
            if not (out / "done").exists():
                try:
                    _run(out)
                except RuntimeError as err:
                    (out / "failed").write_text(str(err))
                    raise
                (out / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
