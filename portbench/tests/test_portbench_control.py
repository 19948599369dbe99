"""The control comes out not correct: the plain reference computed in
fp8 in the program's place, read by ``control.py``'s own functions at a
size a test run holds.  On the CPU the training cells run tiny (a tiny
served model has too few near-ties for fp8 to move its tokens); on the
card (``-m cuda``) the training cells run at their widths with two
layers and the serving cell whole: fp8's error grows with depth, and
four of its 36 layers read 1.16, under the limit set at 36."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import control, spec
from portbench.tests import portbench_tiny as tiny


def _fails(values: dict, limits: dict) -> bool:
    return any(values[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("name", ["granite8b.train_s512",
                                  "granitemoe.train_s1024"])
def test_control_fails_and_the_program_passes_tiny(name):
    c = tiny.cell(name)
    out = control.train_readings(c, 2**31 + 5, torch.device("cpu"),
                                 program=True, control=True, faults=False)
    assert not _fails(out["program"], c.limits), out["program"]
    assert _fails(out["control_fp8"], c.limits), out["control_fp8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite8b.train_s512",
                                  "granitemoe.train_s1024"])
def test_control_fails_at_the_cells_widths(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    real = spec.load(tiny.ROOT, name)
    c = dataclasses.replace(real, config={"model": dict(real.model,
                                                        n_layers=2)})
    out = control.train_readings(c, 2**31 + 7, torch.device("cuda"),
                                 program=True, control=True, faults=False)
    assert not _fails(out["program"], c.limits), out["program"]
    assert _fails(out["control_fp8"], c.limits), out["control_fp8"]


@pytest.mark.cuda
def test_serving_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = spec.load(tiny.ROOT, "granite8b.serve_code")
    out = control.serve_readings(c, 2**31 + 8, torch.device("cuda"),
                                 program=True, control=True, faults=True)
    assert not _fails(out["program"], c.limits), out["program"]
    assert _fails(out["control_fp8"], c.limits), out["control_fp8"]
    assert _fails(out["fault_altered_token"], c.limits)
