"""Tensor-parallel parity at (pod 2, data 2, model 2): every (pod, data)
group on ranks of its own, 8 ranks (the int8 hop's all-gather over real
pod ranks), the port's dist step against the reference's single-device
step for the five dense configs, a clipped step and the int8 hop
(``tests/torch_tp_parity.py`` sets out the construction)."""
import pytest

import torch_tp_parity as parity

LAYOUTS = ["pod2-data2-model2"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_tp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
