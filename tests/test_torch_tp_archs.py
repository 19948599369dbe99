"""Tensor parallelism of the MoE (expert-parallel), SSM, RG-LRU and
encoder–decoder configs: granite-moe-3b-a800m, llama4-maverick,
mamba2-370m, recurrentgemma-2b and whisper-medium at tp 2 (every (pod,
data) group in turn on each of 2 ranks), and granite-moe at 5 experts
(replicated, ``granite-moe-E5@tp2-eprep``), against the reference's
single-device step (``tests/torch_tp_parity.py``)."""
import pytest

import torch_tp_parity as parity

LAYOUTS = ["pod1-data1-model2-archs", "pod1-data4-model2-eprep"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_tp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
