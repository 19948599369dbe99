"""FSDP sessions' checkpoints and the reference's runs, on gloo CPU ranks
(``tests/torch_fsdp_ranks.py``):

  * a world of 2 pods × 2 data ranks under FSDP writes its checkpoints in
    the whole pp-1/tp-1 format: killed after step 2, the file resumes bit
    for bit (losses, params and the adamw state of steps 2 and 3 equal
    the uninterrupted FSDP run's) in one process with ``fsdp=False`` and
    in the same world with ``fsdp=False`` (each rank whole over "data"),
    and a one-process run's checkpoint resumes bit for bit in the FSDP
    world;
  * FSDP over the 4 data ranks of ``homogeneous(2, 4)`` (8 ranks, one a
    (pod, data) group) from the reference's initial params: the coded and
    coded_q int8 runs' losses within 1e-5 relative of the reference's
    (``tests/torch_reference.py``, whose session stores its params FSDP
    too), as ``tests/test_torch_session.py`` holds the one-card runs.
"""
import json
import shutil

import numpy as np
import pytest

import torch_fsdp_ranks as fr
from repro_torch.dist.launch import run_ranks
from torch_reference import (  # noqa: F401 (few_threads: autouse)
    few_threads,
    reference_dir,
)


def _equal(a, b):
    assert a["losses"] == b["losses"]
    for what in ("params", "state"):
        assert set(a[what]) == set(b[what])
        for k, v in b[what].items():
            np.testing.assert_array_equal(a[what][k], v,
                                          err_msg=f"{what} {k}")


def test_fsdp_checkpoint_resumes_bit_for_bit_in_other_layouts(tmp_path):
    ck = tmp_path / "ck"
    whole = run_ranks(fr.checkpoint_run, 4, args=(2, 2, str(tmp_path / "a")),
                      timeout=300)[0]
    run_ranks(fr.checkpoint_run, 4, args=(2, 2, str(ck), True, False, 2),
              timeout=300)
    assert whole["active"]
    for n, (fsdp, world) in enumerate(((False, 1), (False, 4))):
        copy = tmp_path / f"resume{n}"
        shutil.copytree(ck, copy)
        args = (2, 2, str(copy), fsdp, True)
        got = fr.checkpoint_run(*args) if world == 1 else \
            run_ranks(fr.checkpoint_run, world, args=args, timeout=300)[0]
        assert got["start"] == 2 and not got["active"]
        _equal(dict(got, losses=whole["losses"][:2] + got["losses"]), whole)
    # the other way round: a one-process checkpoint into the FSDP world
    one = tmp_path / "one"
    fr.checkpoint_run(2, 2, str(one), False, False, 2)
    got = run_ranks(fr.checkpoint_run, 4, args=(2, 2, str(one), True, True),
                    timeout=300)[0]
    assert got["start"] == 2 and got["active"]
    _equal(dict(got, losses=whole["losses"][:2] + got["losses"]), whole)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_dir(tmp_path_factory)


def test_fsdp_world_matches_reference_runs(reference):
    init = dict(np.load(reference / "params.npz"))
    want = json.loads((reference / "losses.json").read_text())
    runs = [("coded", ""), ("coded_q", "int8")]
    got = run_ranks(fr.reference_run, 8, args=(init, runs), timeout=300)[0]
    for mode, comp in runs:
        np.testing.assert_allclose(got[mode + comp], want[mode + comp],
                                   rtol=1e-5, atol=0)
