"""Pipeline parallelism beyond one microbatch a stage and the optimizer's
stage reductions: ``llama3-8b@pp2m4`` (4 layers, 4 microbatches of one
row: the schedule longer than the pipeline), ``llama3-8b@pp2-clip``
(the clip's global norm sums the stage-split leaves over "stage") and
``gemma3-27b-adafactor@pp2`` (14 layers; adafactor's statistics of a
stacked norm scale reduce over the stage axis), and ``llama3-8b@pp1m2``
(one stage asked for two microbatches, which the dist step ignores, as
the reference's does), against the
reference's single-device step (``tests/torch_pp_parity.py``)."""
import pytest

import torch_pp_parity as parity

LAYOUTS = ["stage2-extra", "stage1-m2"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_pp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
