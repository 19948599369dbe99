"""``CodedSession.shrink`` over ranks of their own (``tests/
test_torch_shrink_ranks.py`` has the layout and the reference's run),
continued on gloo CPU ranks:

  * the reference's ``test_session_shrink_replan_kill_resume_bit_for_bit``
    over ranks: edge 0 dies (so the checkpoint's writer is rank 2, the
    survivors' first), the run checkpoints and steps on; a fresh world
    of the 4 survivors resumes the checkpoint, and its steps equal the
    uninterrupted run's bit for bit;
  * tp 2 survivors: a 3 × 2 × tp 2 world (12 ranks) against the same
    shrink at tp 2 where every group runs on each rank (``pod_ranks =
    1``).
"""
import json
import os
import shutil

import numpy as np

import torch_tp_ranks as ranks
from repro_torch.dist.launch import run_ranks
from torch_reference import SHRINK, few_threads  # noqa: F401 (autouse)


def _live(outs):
    return [o for o in outs if not o["retired"]]


def test_shrink_over_ranks_kill_resume_bit_for_bit(tmp_path):
    ck = tmp_path / "ck"
    whole = run_ranks(ranks.shrink_ranks_run, 6,
                      args=(dict(SHRINK), (0,), str(ck)), timeout=300)
    live = _live(whole)
    assert [o["rank"] for o in live] == [2, 3, 4, 5]
    # the survivors' first rank wrote it; every survivor saw it in place
    assert live[0]["ck_path"] and all(o["ck_path"] == "" for o in live[1:])
    meta = json.loads((ck / "step_0000000003" / "meta.json").read_text())
    assert meta["extra"]["cluster"]["dead_edges"] == [0]
    resumed_dir = tmp_path / "resumed"
    shutil.copytree(ck, resumed_dir)
    resumed = run_ranks(ranks.resume_ranks_run, 4,
                        args=(dict(SHRINK), str(resumed_dir)), timeout=300)
    for r in resumed:
        assert r["start"] == 3 and r["m"] == (2, 2)
        assert r["dead_edges"] == (0,) and r["layout"] == (2, 2, 1)
        # bit for bit, not allclose
        assert r["losses"] == live[0]["losses"][3:]
    for k, v in live[0]["params"].items():
        np.testing.assert_array_equal(resumed[0]["params"][k], v,
                                      err_msg=k)
    assert os.path.isdir(ck / "step_0000000003")


def test_tp2_survivors_match_one_rank_layout():
    """3 × 2 groups × tp 2 (12 ranks, the model axis kept whole by the
    survivors) against the tp-2 world whose two ranks run every group:
    each rank quantizes the same slice on the int8 hop in both layouts,
    so losses and params agree to float32 summation order (the pod sum
    of 3 or 2 ranks against one rank's running sum)."""
    one = run_ranks(ranks.shrink_ranks_run, 2,
                    args=(dict(SHRINK, tp=2),), timeout=300)
    full = run_ranks(ranks.shrink_ranks_run, 12,
                     args=(dict(SHRINK, tp=2),), timeout=300)
    assert one[0]["layout"] == (1, 1, 2) and full[0]["layout"] == (3, 2, 2)
    live = _live(full)
    assert [o["rank"] for o in live] == [0, 1, 2, 3, 8, 9, 10, 11]
    want = one[0]
    np.testing.assert_array_equal(want["after"], want["before"][[0, 2]])
    for o in live:
        np.testing.assert_array_equal(o["after"], o["before"][[0, 2]])
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=1e-6,
                                   atol=0)
    for k, v in want["params"].items():
        np.testing.assert_allclose(live[0]["params"][k], v, rtol=0,
                                   atol=1e-6 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)
