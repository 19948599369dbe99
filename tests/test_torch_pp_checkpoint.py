"""Checkpoints of a pipeline-parallel session (2 ranks of
``dist.launch.run_ranks``, gloo on the CPU; adamw, the int8 hop):

  * a checkpoint written at pp 2 restores at pp 1, and one written at pp
    1 restores at pp 2 (the params and the optimizer state equal the
    file's arrays: checkpoints hold the pp-1/tp-1 format);
  * kill/resume at pp 2 repeats the uninterrupted run's losses and
    params bit for bit.
"""
import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro_torch.checkpoint.params import _flatten
from repro_torch.checkpoint.store import CheckpointStore, config_hash
from repro_torch.dist.launch import run_ranks

SESSION = dict(arch="llama3-8b", cluster=("hetero", 3, 2), planner="fixed",
               mode="coded", seq_len=16, optimizer="sgd", lr=0.05,
               total_steps=4, seed=0)
CKPT = dict(SESSION, mode="coded_int8", optimizer="adamw", lr=1e-3,
            checkpoint_every=2)


def _file_arrays(ckpt_dir):
    store = CheckpointStore(str(ckpt_dir), cfg_hash=config_hash(
        ranks.f32_cfg("llama3-8b")))
    step, state, _ = store.restore()
    return step, _flatten(state["params"]), _flatten(state["opt_state"])


def _equal_to_file(got, ckpt_dir):
    step, params, opt = _file_arrays(ckpt_dir)
    assert got["step"] == step == 2
    assert set(got["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    assert set(got["opt_state"]) == set(opt)
    for k, v in opt.items():
        np.testing.assert_array_equal(got["opt_state"][k], v, err_msg=k)


@pytest.mark.parametrize("writer,reader", [(2, 1), (1, 2)],
                         ids=["pp2-to-pp1", "pp1-to-pp2"])
def test_checkpoint_restores_at_the_other_degree(tmp_path, writer, reader):
    def run(pp, resume):
        args = (dict(CKPT, pp=pp) if pp > 1 else dict(CKPT),
                dict(steps=4, stop_after=2), str(tmp_path), resume)
        if pp == 1:
            return ranks.pp_checkpoint_run(*args)
        return run_ranks(ranks.pp_checkpoint_run, pp, args=args,
                         timeout=300)[0]

    wrote = run(writer, False)
    assert len(wrote["losses"]) == 2
    _equal_to_file(run(reader, True), tmp_path)


def test_pp2_kill_resume_bit_for_bit(tmp_path):
    out = run_ranks(ranks.pp_kill_resume, 2,
                    args=(dict(CKPT, pp=2), str(tmp_path), 4, 2),
                    timeout=300)[0]
    assert len(out["whole"]) == 4 and out["start"] == 2
    assert out["killed"] == out["whole"][:2]
    assert out["resumed"] == out["whole"][2:]
    whole, resumed = out["params"]
    for k, v in whole.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
