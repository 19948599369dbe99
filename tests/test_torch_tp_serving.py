"""Tensor parallelism of the port beyond the train step: serving,
sessions, checkpoints, the CLIs, the checks.

  * serving at tp 2 in float32 (ranks of ``dist.launch.run_ranks``,
    gloo on the CPU): greedy tokens equal to the reference's at tp 1
    (``repro.api.serving.generate``, through its functions: its serve
    CLI's own tp-2 test fails on this tree, ROADMAP.md §3) and forward
    logits within ``tests/test_torch_transformer.py``'s tolerance, for
    each dense config (and starcoder2-3b at tp 4);
  * a tp-2 ``CodedSession`` with a forced drop and a replan against the
    tp-1 session; a tp-2 checkpoint against the tp-1 one (the full
    arrays), restored at tp 1 bit for bit, and killed and resumed at tp
    2 bit for bit; the train CLI at ``--tp 2``;
  * ``validate_tp``'s messages against the reference's, and the
    pipeline's options beside TP held to the reference's checks.

The MoE, SSM, RG-LRU and encoder–decoder configs at tp 2 are served in
``tests/test_torch_tp_serving_archs.py``, sequence parallelism's
sessions in ``tests/test_torch_tp_sp_session.py``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.dist import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.api import CodedCluster, CodedSession
from repro_torch.checkpoint.store import read_npz
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import sharding
from repro_torch.dist.launch import run_ranks
from repro_torch.launch import train
from repro_torch.models import transformer as tf

TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_transformer.py's, on logits
GEN, MAX_LEN = 12, 32
SERVE = [(arch, 2, False) for arch in ranks.DENSE] + [
    ("llama3-8b", 2, True), ("starcoder2-3b", 4, False)]


def _serve_inputs(arch, i):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(11 + i), cfg)
    prompt = np.random.default_rng(12 + i).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32)
    return cfg, params, prompt


@pytest.fixture(scope="module")
def served():
    """(arch, tp, exact) → (reference tokens and logits, rank 0's)."""
    out = {}
    for tp in sorted({t for _, t, _ in SERVE}):
        cases, want = [], []
        for i, (arch, t, exact) in enumerate(SERVE):
            if t != tp:
                continue
            cfg, params, prompt = _serve_inputs(arch, i)
            toks = jserving.generate(params, cfg, prompt, GEN,
                                     max_len=MAX_LEN, exact_handoff=exact)
            logits, _ = jtf.forward(params, cfg, prompt)
            want.append(((arch, t, exact),
                         (np.asarray(toks), np.asarray(logits))))
            cases.append(dict(
                arch=arch, prompt=prompt, gen=GEN, max_len=MAX_LEN,
                exact=exact, params={k: np.asarray(v) for k, v in
                                     _flatten(params).items()}))
        got = run_ranks(ranks.serve_cases, tp, args=(cases, tp),
                        timeout=300)
        for n, (key, ref) in enumerate(want):
            out[key] = (ref, [g[n] for g in got])
    return out


@pytest.mark.parametrize("arch,tp,exact", SERVE,
                         ids=[f"{a}-tp{t}" + ("-exact" if e else "")
                              for a, t, e in SERVE])
def test_tp_serving_matches_reference_tp1(served, arch, tp, exact):
    (toks, logits), per_rank = served[(arch, tp, exact)]
    for got in per_rank:  # every rank decodes the same tokens
        np.testing.assert_array_equal(got["tokens"], toks)
        np.testing.assert_allclose(got["logits"], logits, **TOL)


# ----------------------------------------------------------------------
# sessions and checkpoints
# ----------------------------------------------------------------------
SESSION = dict(arch="llama3-8b", mode="coded", optimizer="adamw",
               total_steps=4, seq_len=16, cluster=("hetero", 2, 4))
FIT = dict(replan_every=2, force_drop_edge=1, force_drop_step=2)


def test_tp2_session_with_drop_and_replan_matches_tp1():
    tp2 = run_ranks(ranks.session_run, 2,
                    args=(dict(SESSION, tp=2), FIT), timeout=300)[0]
    tp1 = ranks.session_run(dict(SESSION), FIT)
    assert len(tp2["losses"]) == 4
    np.testing.assert_allclose(tp2["losses"], tp1["losses"], rtol=0,
                               atol=1e-5)
    for k, v in tp1["params"].items():
        np.testing.assert_allclose(tp2["params"][k], v, rtol=0, atol=1e-4,
                                   err_msg=k)


# momentum: a state leaf per param, linear in the gradients (adam's first
# steps are sign-like: a gradient value that the int8 hop rounds to 0 at
# one degree and to one quantum at the other moves by the learning rate)
# no warm-up: both steps before the checkpoint move the params
CKPT = dict(arch="llama3-8b", mode="coded_q", optimizer="momentum",
            total_steps=4, seq_len=16, warmup_steps=0,
            cluster=("homogeneous", 2, 4))
CKPT_FIT = dict(force_drop_edge=1, force_drop_step=1)


def _step_dir(d):
    return d / f"step_{2:010d}"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """tp-2 and tp-1 runs killed at step 2 with a checkpoint there, a
    tp-2 run resumed from it, and an uninterrupted tp-2 run."""
    d2, d1 = (tmp_path_factory.mktemp(n) for n in ("ck_tp2", "ck_tp1"))

    def kw(tp, d, resume=False):
        # the resumed run writes no checkpoint: step 2's stays the latest
        return dict(CKPT, tp=tp, checkpoint_dir=str(d),
                    checkpoint_every=100 if resume else 2, resume=resume)

    killed = run_ranks(ranks.session_run, 2,
                       args=(kw(2, d2), dict(CKPT_FIT, stop_after=2)),
                       timeout=300)[0]
    ranks.session_run(kw(1, d1), dict(CKPT_FIT, stop_after=2))
    resumed = run_ranks(ranks.session_run, 2,
                        args=(kw(2, d2, resume=True), CKPT_FIT),
                        timeout=300)[0]
    whole = run_ranks(ranks.session_run, 2,
                      args=(dict(CKPT, tp=2), CKPT_FIT), timeout=300)[0]
    return d2, d1, killed, resumed, whole


def test_tp2_checkpoint_holds_the_tp1_arrays(checkpoints):
    d2, d1 = checkpoints[:2]
    s = CodedSession(CodedCluster.homogeneous(2, 4), ranks.f32_cfg(
        CKPT["arch"]), mode="coded_q", optimizer="momentum", total_steps=4,
        seq_len=16, warmup_steps=0, device="cpu", verbose=False)
    start = {"params/" + k: v for k, v in s.full_params().items()}
    for name in ("state.npz", "extra.npz"):
        a = read_npz(str(_step_dir(d2) / name))
        b = read_npz(str(_step_dir(d1) / name))
        assert set(a) == set(b)
        for k in b:
            # a residual kept whole on each rank would gather to twice
            # its leaf's shape
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            assert np.isfinite(a[k]).all(), k
            if k.startswith("ef_residual/"):
                # the rounding errors of different blocks (each rank
                # quantizes its own slice), no larger than half their
                # block's int8 step at either degree: their values are
                # not comparable, and their slicing is held bit for bit
                # by the restore and kill/resume tests
                continue
            # params and momentum: each of the two quantized steps may
            # round differently at the two degrees by one int8 step
            # (block max / 127) of what it adds, so the degrees agree to
            # 2/127 of the leaf's movement since step 0 (measured at
            # most 0.0062 of it; a lost or halved update is 1 or 0.5)
            moved = np.max(np.abs(b[k] - start.get(k, 0.0)))
            assert moved > 0, k
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=2 / 127 * moved, err_msg=k)


def test_tp2_checkpoint_restores_at_tp1_bit_for_bit(checkpoints):
    d2 = checkpoints[0]
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg, mode="coded_q",
                     optimizer="momentum", total_steps=4, seq_len=16,
                     checkpoint_dir=str(d2), resume=True, device="cpu",
                     verbose=False)
    assert s._step == 2
    state = read_npz(str(_step_dir(d2) / "state.npz"))
    mine = {"params/" + k: v.detach().numpy()
            for k, v in _flatten_t(s.params).items()}
    mine.update({"opt_state/" + k: v.numpy()
                 for k, v in _flatten_t(s.opt_state).items()})
    assert set(mine) == set(state)
    for k, v in state.items():
        assert mine[k].shape == v.shape and np.array_equal(mine[k], v), k
    extra = read_npz(str(_step_dir(d2) / "extra.npz"))
    from repro_torch.checkpoint.params import leaf_keys

    for key, r in zip(leaf_keys(s.params), s.residual):
        want = extra["ef_residual/" + key]
        assert r.shape == want.shape and np.array_equal(r.numpy(), want), key
    s.fit()
    assert len(s.losses) == 2 and np.isfinite(s.losses).all()


def _flatten_t(tree):
    from repro_torch.checkpoint.params import _flatten as flat

    return flat(tree)


def test_tp2_kill_resume_bit_for_bit(checkpoints):
    _, _, killed, resumed, whole = checkpoints
    assert killed["losses"] + resumed["losses"] == whole["losses"]
    for k, v in whole["params"].items():
        assert np.array_equal(resumed["params"][k], v), k


def test_train_cli_tp2(tmp_path):
    out = tmp_path / "m.json"
    full = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--seq-len", "16", "--dist", "coded_q", "--tp", "2",
                       "--metrics-out", str(out)], full_params=True)
    losses = json.load(open(out))["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    cfg = get_smoke_config("llama3-8b")
    shapes = {k: tuple(v.shape) for k, v in
              _flatten_t(tf.init_params(cfg, device="meta")).items()}
    assert {k: v.shape for k, v in full.items()} == shapes


# ----------------------------------------------------------------------
# the checks
# ----------------------------------------------------------------------
BAD_TP = [("llama3-8b", 3, {}), ("starcoder2-3b", 2, dict(n_heads=6,
                                                          n_kv_heads=3)),
          ("mamba2-370m", 3, {}), ("recurrentgemma-2b", 3, {}),
          ("gemma3-27b", 5, {})]


@pytest.mark.parametrize("arch,tp,change", BAD_TP,
                         ids=[a for a, _, _ in BAD_TP])
def test_validate_tp_messages_match_reference(arch, tp, change):
    mine = dataclasses.replace(get_smoke_config(arch), **change)
    theirs = dataclasses.replace(ref_smoke(arch), **change)
    with pytest.raises(ValueError) as want:
        jsharding.validate_tp(theirs, tp)
    with pytest.raises(ValueError) as got:
        sharding.validate_tp(mine, tp)
    assert str(got.value) == str(want.value)
    for good in (1, 2):
        sharding.validate_tp(get_smoke_config("llama3-8b"), good)


def test_deferred_regimes_raise():
    cfg = get_smoke_config("llama3-8b")
    cl = CodedCluster.homogeneous(2, 4)
    # the pipeline's options are ported: the reference's checks
    with pytest.raises(RuntimeError, match="run_ranks"):
        CodedSession(cl, cfg, mode="coded", tp=2, pp=2, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="microbatches requires pp > 1"):
        CodedSession(cl, cfg, mode="coded", tp=2, microbatches=2,
                     device="cpu", verbose=False)
    with pytest.raises(ValueError, match="pp > 1 requires a dist mode"):
        CodedSession(cl, cfg, mode="off", pp=2, device="cpu", verbose=False)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps

    # one host ignores them, as the reference's make_train_step does
    for tcfg in (TrainConfig(pp_stages=2), TrainConfig(microbatches=2)):
        steps.make_train_step(cfg, tcfg)
    with pytest.raises(ValueError, match="coded mode"):
        CodedSession(cl, cfg, mode="off", tp=2, device="cpu", verbose=False)
