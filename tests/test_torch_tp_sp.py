"""Sequence parallelism of the port's dist step: the five dense configs
with their activations sequence-sharded over 2 "model" ranks between
the TP collective pairs (every (pod, data) group in turn on each rank),
against the reference's single-device step
(``tests/torch_tp_parity.py``; the reference test's ``@sp`` cases)."""
import pytest

import torch_tp_parity as parity

LAYOUTS = ["pod1-data1-model2-sp"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_sp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
