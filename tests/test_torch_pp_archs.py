"""Pipeline parallelism of the MoE, SSM, RG-LRU and encoder–decoder
configs at pp 2: granite-moe-3b-a800m and llama4-maverick (one
microbatch: their capacity and aux depend on the token count),
mamba2-370m and its tied table (stage 0's embedding and the last
stage's head), recurrentgemma-2b (8 layers: two groups and two rest
layers on the last stage) and whisper-medium (the encoder on every
stage, its gradient summed over "stage"), against the reference's
single-device step (``tests/torch_pp_parity.py``)."""
import pytest

import torch_pp_parity as parity

LAYOUTS = ["stage2-archs-b"]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_pp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
