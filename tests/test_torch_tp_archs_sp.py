"""Sequence parallelism of the MoE, SSM, RG-LRU and encoder–decoder
configs at tp 2: the MoE layer gathers the sequence before routing, the
recurrent blocks before their scans, whisper's encoder stays unsharded;
against the reference's single-device step
(``tests/torch_tp_parity.py``; the reference test's ``@sp`` cases)."""
import warnings

import pytest

import torch_tp_parity as parity

LAYOUTS = ["pod1-data1-model2-archs-sp"]


@pytest.fixture(scope="module")
def port_steps():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the recurrent SP fallback
        return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_sp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)
