"""Tensor-parallel parity with only the "model" axis over ranks: every
(pod, data) group in turn on each of 2 ranks (the five dense configs and
the int8 hop), and starcoder2-3b at tp 4 (2 KV heads: K/V replicated,
each rank slicing the head of its Q block), against the reference's
single-device step (``tests/torch_tp_parity.py``)."""
import pytest

import torch_tp_parity as parity

LAYOUTS = ["pod1-data1-model2", "pod1-data1-model4"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_tp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
