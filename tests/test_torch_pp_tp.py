"""Pipeline parallelism composed with tensor and sequence parallelism:
``llama3-8b@pp2tp2``, ``@pp2tp2sp`` (the handoff carries the local
sequence block) and ``@pp2tp2sp-int8`` (each stage quantizes its own
slices on the hop) at (stage 2, model 2), 4 ranks, every (pod, data)
group in turn on each, against the reference's single-device step
(``tests/torch_pp_parity.py``).

Sessions at pp 2 (2 ranks) and at pp 2 × tp 2 with sequence sharding (4
ranks) in coded_int8 under momentum, 4 steps with edge 1 dropped at step
1, against pp 1: the momentum and the EF residuals, a rank's slices,
carry across the steps and the drop.  Every loss within 1e-5 relative,
each leaf within 2/127 of its movement (under TP each rank quantizes its
own slices' partials on the int8 hop), each EF residual leaf within 0.1
of pp 1's norm (at pp 2 its difference, under TP its size)."""
import numpy as np
import pytest

import torch_pp_parity as parity
import torch_tp_ranks as ranks
from repro_torch.dist.launch import run_ranks

LAYOUTS = ["stage2-model2"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_pp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)


PP_TP = dict(arch="llama3-8b", cluster=("hetero", 3, 2), planner="fixed",
             mode="coded_int8", seq_len=16, optimizer="momentum", lr=0.05,
             warmup_steps=0, total_steps=4, seed=0)
PP_TP_FIT = dict(steps=4, force_drop_edge=1, force_drop_step=1)


@pytest.fixture(scope="module")
def pp1_state():
    return ranks.session_run(dict(PP_TP), dict(PP_TP_FIT), with_state=True)


@pytest.mark.parametrize("layout", [dict(pp=2),
                                    dict(pp=2, tp=2, seq_shard=True)],
                         ids=["pp2", "pp2tp2sp"])
def test_pp_session_carries_state_as_pp1(pp1_state, layout):
    want = pp1_state
    got = run_ranks(ranks.session_run, 2 * layout.get("tp", 1),
                    args=(dict(PP_TP, **layout), dict(PP_TP_FIT), 0, True),
                    timeout=300)[0]
    assert len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        moved = np.max(np.abs(v - want["start"][k]))
        assert moved > 0, k
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=2 / 127 * moved, err_msg=k)
    for k, v in want["residual"].items():
        ref = np.linalg.norm(v)
        assert ref > 0, k
        if "tp" in layout:
            # other int8 blocks (a rank's slices): the rounding errors
            # differ element by element, their size does not (read 5.1%)
            assert abs(np.linalg.norm(got["residual"][k]) / ref - 1) < 0.1, k
        else:
            # a stage's block of a leaf holds whole int8 blocks: the same
            # rounding errors but where an f32 sum rounds across a
            # boundary (read 0.034 of the norm)
            assert np.linalg.norm(got["residual"][k] - v) / ref < 0.1, k
