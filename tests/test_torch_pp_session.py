"""Pipeline parallelism through the session:

  * a pp-2 ``CodedSession`` (2 ranks of ``dist.launch.run_ranks``, gloo
    on the CPU) against the same session at pp 1: every loss within 1e-5
    relative, and the params at the end;
  * ``shrink`` at pp 2 (the mesh rebuilt with its stage axis, the
    surviving pods keeping their EF rows) held to pp 1 within 2/127 of
    each leaf's movement, as ``test_torch_tp_sp_session.py`` holds tp 2;
  * ``eval_step`` and ``generate`` of a pp-2 session (the whole model
    gathered first) equal pp 1's;
  * the session's pipeline checks (the reference's messages): the
    microbatches need pp > 1, pp > 1 needs a dist mode, a pp > 1 session
    is one rank of a world, and a bad degree fails ``validate_pp``.

Checkpoints across degrees and kill/resume at pp 2:
``tests/test_torch_pp_checkpoint.py``; the train CLI at ``--pp 2``:
``tests/test_torch_pp_cli.py``; sessions carrying their state across
steps and a drop at pp 2 and pp 2 × tp 2: ``tests/test_torch_pp_tp.py``.
"""
import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro_torch.api import CodedCluster, CodedSession
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.launch import run_ranks

SESSION = dict(arch="llama3-8b", cluster=("hetero", 3, 2), planner="fixed",
               mode="coded", seq_len=16, optimizer="sgd", lr=0.05,
               total_steps=4, seed=0)


def test_pp2_session_matches_pp1():
    want = ranks.session_run(dict(SESSION), dict(steps=4))
    got = run_ranks(ranks.session_run, 2,
                    args=(dict(SESSION, pp=2), dict(steps=4)),
                    timeout=300)[0]
    assert len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=3e-5,
                                   err_msg=k)


def test_pp2_eval_and_generate_match_pp1():
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (2, 16)),
             "targets": rng.integers(0, 256, (2, 16)),
             "weights": np.ones((2, 16), np.float32)}
    prompts = rng.integers(0, 256, (2, 8))
    args = (batch, prompts, 4)
    want = ranks.eval_generate_run(dict(SESSION), *args)
    got = run_ranks(ranks.eval_generate_run, 2,
                    args=(dict(SESSION, pp=2),) + args, timeout=300)[0]
    for k, v in want["eval"].items():
        assert abs(got["eval"][k] - v) <= 1e-6 * max(abs(v), 1), k
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


SHRINK = dict(seq_len=16, optimizer="sgd", lr=0.05, total_steps=6, seed=0)


def test_pp2_shrink_matches_pp1():
    """The shrink at pp 2 against pp 1: every loss, and every leaf within
    2/127 of its movement over the six steps (each stage quantizes its
    own leaves' partials on the int8 hop)."""
    want = ranks.shrink_run(dict(SHRINK))
    got = run_ranks(ranks.shrink_run, 2, args=(dict(SHRINK, pp=2),),
                    timeout=300)[0]
    assert want["pods"] == got["pods"] == 2
    assert len(got["losses"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    for r in (want, got):
        np.testing.assert_array_equal(r["after"], r["before"][[0, 2]])
    for k, v in want["params"].items():
        moved = np.max(np.abs(v - want["start"][k]))
        assert moved > 0, k
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=2 / 127 * moved, err_msg=k)


def test_session_pp_checks():
    cfg = get_smoke_config("llama3-8b")
    cl = CodedCluster.homogeneous(2, 4)
    with pytest.raises(ValueError, match="microbatches requires pp > 1"):
        CodedSession(cl, cfg, mode="coded", microbatches=2, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="pp > 1 requires a dist mode"):
        CodedSession(cl, cfg, mode="off", pp=2, device="cpu",
                     verbose=False)
    with pytest.raises(ValueError, match="divisib"):
        CodedSession(cl, get_smoke_config("granite-8b"), mode="coded",
                     pp=2, device="cpu", verbose=False)
    with pytest.raises(RuntimeError, match="run_ranks"):
        CodedSession(cl, cfg, mode="coded", pp=2, device="cpu",
                     verbose=False)
