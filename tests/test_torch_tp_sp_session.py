"""Sequence parallelism's checks and sessions, and ``shrink`` under
tensor parallelism:

  * ``validate_seq_shard``'s errors and its warning for the recurrent
    kinds against the reference's, and a session's ``seq_shard`` checks
    (a dist mode, tp > 1, a sequence divisible by tp);
  * a tp-2 ``CodedSession`` (ranks of ``dist.launch.run_ranks``, gloo on
    the CPU), with and without ``seq_shard``, that loses edge 1 for good
    after 3 steps (``shrink``: the mesh rebuilt on the survivors, each
    surviving pod keeping its EF residual rows) and steps 3 more, held
    to the same run at tp 1 (which ``tests/test_torch_checkpoint.py``
    holds to the reference);
  * the train CLI at ``--tp 2 --seq-shard``.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.dist import sharding as jsharding
from repro_torch.api import CodedCluster, CodedSession
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import sharding
from repro_torch.dist.launch import run_ranks
from repro_torch.launch import steps, train

BAD_SP = [("llama3-8b", 1, 16), ("llama3-8b", 2, 15), ("gemma3-27b", 4, 18)]


@pytest.mark.parametrize("arch,tp,seq", BAD_SP,
                         ids=[f"{a}-tp{t}-seq{s}" for a, t, s in BAD_SP])
def test_validate_seq_shard_errors_match_reference(arch, tp, seq):
    with pytest.raises(ValueError) as want:
        jsharding.validate_seq_shard(ref_smoke(arch), tp, seq)
    with pytest.raises(ValueError) as got:
        sharding.validate_seq_shard(get_smoke_config(arch), tp, seq)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b",
                                  "llama3-8b"])
def test_validate_seq_shard_warning_matches_reference(arch):
    """The recurrent kinds gather before their scans: a warning, the
    reference's words; none for an attention-only config."""
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jsharding.validate_seq_shard(ref_smoke(arch), 2, 16)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        sharding.validate_seq_shard(get_smoke_config(arch), 2, 16)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert len(got) == (0 if arch == "llama3-8b" else 1)


def test_session_seq_shard_checks():
    cfg = get_smoke_config("llama3-8b")
    cl = CodedCluster.homogeneous(2, 4)
    with pytest.raises(ValueError, match="requires a dist mode"):
        CodedSession(cl, cfg, mode="off", seq_shard=True, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="requires tensor parallelism"):
        CodedSession(cl, cfg, mode="coded", seq_shard=True, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="seq_len=15 % tp=2"):
        CodedSession(cl, cfg, mode="coded", tp=2, seq_shard=True,
                     seq_len=15, device="cpu", verbose=False)
    # a valid SP session is a rank of a world, as any tp-2 session
    with pytest.raises(RuntimeError, match="run_ranks"):
        CodedSession(cl, cfg, mode="coded", tp=2, seq_shard=True,
                     seq_len=16, device="cpu", verbose=False)
    # one host: the sequence axis has no ranks to split over (the
    # reference's ShardCtx.sp is off at tp 1), so the step builds
    steps.make_train_step(cfg, TrainConfig(seq_shard_activations=True))


SHRINK = dict(seq_len=16, optimizer="sgd", lr=0.05, total_steps=6, seed=0)


@pytest.fixture(scope="module")
def shrunk():
    out = {"tp1": ranks.shrink_run(dict(SHRINK))}
    for name, sp in (("tp2", False), ("tp2-sp", True)):
        out[name] = run_ranks(ranks.shrink_run,
                              2, args=(dict(SHRINK, tp=2, seq_shard=sp),),
                              timeout=300)[0]
    return out


@pytest.mark.parametrize("run", ["tp2", "tp2-sp"])
def test_tp2_shrink_matches_tp1(shrunk, run):
    """The shrink at tp 2 (each rank's slices of the residual rows carried
    through the rebuild) against tp 1: every loss, and every leaf within
    2/127 of its movement over the six steps, the checkpoint tests' limit
    (each rank quantizes its own slice on the int8 hop, so the degrees
    part by about one int8 step of an update: measured 0.0069 of the
    movement, and 4.3e-7 of the loss)."""
    want, got = shrunk["tp1"], shrunk[run]
    assert want["pods"] == got["pods"] == 2
    assert len(got["losses"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    # the surviving pods' rows rode the rebuild: pods 0 and 2 of 3
    for r in (want, got):
        np.testing.assert_array_equal(r["after"], r["before"][[0, 2]])
        assert np.abs(r["after"]).max() > 0
    for k, v in want["params"].items():
        moved = np.max(np.abs(v - want["start"][k]))
        assert moved > 0, k
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=2 / 127 * moved, err_msg=k)


def test_train_cli_tp2_seq_shard(tmp_path):
    """``--tp 2 --seq-shard`` trains and agrees with ``--tp 2`` (SP moves
    where the work is done, not its values; f32 sums in another order).
    sgd: adam's first steps would magnify the rounding of gradients near
    zero to whole steps of the learning rate."""
    outs = []
    for extra in ([], ["--seq-shard"]):
        out = tmp_path / f"m{len(outs)}.json"
        train.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--seq-len", "16", "--dist", "coded", "--tp", "2",
                    "--optimizer", "sgd", "--lr", "0.05",
                    "--metrics-out", str(out)] + extra)
        outs.append(json.load(open(out))["losses"])
    assert len(outs[1]) == 3 and np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=0)
