"""Pipeline parallelism over the int8 + error-feedback hop with every
(pod, data) group on ranks of its own: ``llama3-8b@pp2int8`` at (stage
2, pod 2, data 2), 8 ranks, so that the hop's all-gather crosses pod
ranks and each stage's EF residual rows are its slices, against the
reference's single-device step (``tests/torch_pp_parity.py``)."""
import pytest

import torch_pp_parity as parity

LAYOUTS = ["stage2-pod2-data2"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_pp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
