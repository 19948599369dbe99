"""``CodedSession.shrink`` where the pods and workers are ranks of their
own (``pod_ranks = pods``, ``data_ranks = data``: the reference's layout
of one device per (pod, data) group), on gloo CPU ranks of
``dist.launch.run_ranks``:

  * the reference's ``test_session_shrink_in_dist_int8_carries_residual``
    (hetero(3, 2), the llama3-8b smoke config in float32, coded_int8,
    sgd at lr 0.05) on 6 ranks from the reference's initial params: the
    surviving pods' EF residual rows bit for bit, every loss within 1e-5
    relative of the reference's subprocess run (``tests/
    torch_reference.py``, 8 host devices); before it, an uneven shrink
    (worker (0, 1)) raises the non-uniform topology's error and leaves
    the session as it was; the dead pod's ranks retire, and a step
    there raises.

``tests/test_torch_shrink_ranks_resume.py`` holds kill/resume and tp 2
over such ranks.
"""
import json

import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro_torch.dist.launch import run_ranks
from torch_reference import (  # noqa: F401 (few_threads: autouse)
    SHRINK,
    few_threads,
    reference_dir,
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_dir(tmp_path_factory)


@pytest.fixture(scope="module")
def world(reference):
    init = dict(np.load(reference / "params.npz"))
    return run_ranks(ranks.shrink_ranks_run, 6,
                     args=(dict(SHRINK), (1,), "", init, True),
                     timeout=300)


def _live(outs):
    return [o for o in outs if not o["retired"]]


def test_shrink_over_ranks_carries_rows_and_matches_reference(world,
                                                              reference):
    assert all(o["layout"] == (3, 2, 1) for o in world)
    live = _live(world)
    assert [o["rank"] for o in live] == [0, 1, 4, 5]
    want = json.loads((reference / "losses.json").read_text())["shrink"]
    ref_rows = np.load(reference / "shrink_residual.npz")
    for o in live:
        # pods 0 and 2 of 3 kept their live rows, bit for bit, not zeros
        np.testing.assert_array_equal(o["after"], o["before"][[0, 2]])
        assert np.abs(o["after"]).max() > 0
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=0)
        assert o["after"].shape == ref_rows["after"].shape
    # pod 2 of 3 is pod 1 of 2 now; data coordinates unchanged
    assert [o["mesh"][1:] for o in live] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["mesh"][0] == (0, 1, 4, 5) for o in live)
    for o in live[1:]:
        assert o["losses"] == live[0]["losses"]


def test_uneven_shrink_over_ranks_raises_and_keeps_session(world):
    """Losing worker (0, 1) alone leaves m = (1, 2, 2): the error
    ``_setup_train_step`` raises for it, before any rank retires; the
    session keeps its cluster and code (the losses above still match)."""
    for o in world:
        msg, m, code_m = o["uneven"]
        assert msg == ("dist modes need a uniform topology for the (pod, "
                       "data) mesh, got m=(1, 2, 2)")
        assert m == code_m == (2, 2, 2)


def test_dead_ranks_retire_and_refuse_steps(world):
    dead = [o for o in world if o["retired"]]
    assert [o["rank"] for o in dead] == [2, 3]
    for o in dead:
        assert o["plan_m"] == (2, 2)  # the plan, as every rank returns it
        assert "was shrunk away" in o["error"]
        assert "after" not in o and "losses" not in o
