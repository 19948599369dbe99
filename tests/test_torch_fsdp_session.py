"""FSDP over the data ranks in coded training (``CodedSession(fsdp=...)``,
the reference's ``TrainConfig.fsdp`` default) on gloo CPU ranks.

Worlds of pods × data ranks at (1, 2) and (2, 2) (the smoke llama3-8b
in float32, ``tests/torch_fsdp_ranks.py``) run each of modes coded and
coded_q int8 under sgd, momentum, adamw and adafactor for 4 steps (edge 1
dropped at step 2 where there are two pods), with ``fsdp`` False and
True:

  * FSDP changes where the state lives, not what is computed: losses and
    the gathered params equal the ``fsdp=False`` run's bit for bit for
    sgd, momentum and adamw.  adafactor's factored row and column means
    over a split dim are means of the data ranks' means: its losses
    agree within 1e-6 relative, and in mode coded its params within 1e-5
    of their largest magnitude (the float32 rounding of a mean of means
    carried through four updates normalized to unit RMS: 3.3e-7 of
    |param| ≤ 0.23 here); coded_q int8 rounds each gradient to the int8
    grid, so there a last-bit difference may move a value by one
    quantization step: those params are not held;
  * each rank holds exactly its blocks: the elements of its params and
    optimizer state equal the slice arithmetic (a split dim over the data
    count, ``state_axis`` for the state), half the whole at data 2 for
    the split leaves; with ``fsdp=False`` every rank holds them whole.

One world per layout serves every case.
"""
import numpy as np
import pytest

import torch_fsdp_ranks as fr
from repro_torch.dist.launch import run_ranks
from torch_reference import few_threads  # noqa: F401 (autouse)

LAYOUTS = {"pod1-data2": (1, 2), "pod2-data2": (2, 2)}
CASES = [(m, c, o) for m, c in fr.MODES for o in fr.OPTIMIZERS]


@pytest.fixture(scope="module")
def worlds():
    return {name: run_ranks(fr.parity_run, pods * data,
                            args=(pods, data, CASES), timeout=300)
            for name, (pods, data) in LAYOUTS.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}-{c[2]}")
def test_fsdp_session_equals_fsdp_false(worlds, layout, case):
    outs = worlds[layout]
    whole, split = outs[0][case + (False,)], outs[0][case + (True,)]
    assert split["active"] and not whole["active"]
    for o in outs[1:]:  # every rank reports the decoded loss
        assert o[case + (True,)]["losses"] == split["losses"]
    assert set(split["params"]) == set(whole["params"])
    if case[2] != "adafactor":
        assert split["losses"] == whole["losses"]
        for k, v in whole["params"].items():
            np.testing.assert_array_equal(split["params"][k], v, err_msg=k)
        return
    np.testing.assert_allclose(split["losses"], whole["losses"], rtol=1e-6,
                               atol=0)
    if case[0] == "coded":
        for k, v in whole["params"].items():
            np.testing.assert_allclose(split["params"][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_hold_their_blocks(worlds, layout):
    for case in CASES:
        for o in worlds[layout]:
            whole, split = o[case + (False,)], o[case + (True,)]
            assert split["held"] == split["want"], (case, split)
            assert whole["held"] == whole["want"], case
            assert split["held"]["params"] < whole["held"]["params"]
            if case[2] != "sgd":
                assert split["held"]["state"] < whole["held"]["state"]
