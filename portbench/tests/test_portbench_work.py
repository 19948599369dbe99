"""The yardstick's FLOP and bound arithmetic against hand counts."""
from __future__ import annotations

import json

import pytest

from portbench import work
from portbench.tests.portbench_tiny import ROOT


def model(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_granite8b_matmul_params_and_step_flops():
    m = model("granite-8b-stage6")
    # per layer: q 4096², k and v 4096·1024 each, o 4096², swiglu 3·4096·14336
    layer = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert work.matmul_params(m) == 6 * layer + 4096 * 49152
    assert work.matmul_params(m) == 1_509_949_440
    # 32 computed rows of 512: 2·P·tokens + attention 4·H·Dh·pairs a layer
    fwd = 2 * 1_509_949_440 * 32 * 512 + 32 * 6 * 4 * 32 * 128 * (
        512 * 513 // 2)
    assert work.train_step_flops(m, 32, 512) == 3 * fwd


def test_granite_moe_counts_top_k_experts_and_router():
    m = model("granite-moe-3b-a800m-stage16")
    attn = 1536 * 1536 + 2 * 1536 * 512 + 1536 * 1536
    ffn = 8 * 3 * 1536 * 512 + 1536 * 40
    assert work.matmul_params(m) == 16 * (attn + ffn) + 1536 * 49155


def test_serving_flops_of_prefill_and_decode():
    m = model("granite-8b")
    P = work.matmul_params(m)
    head = 4096 * 49152
    attn = 36 * 4 * 32 * 128
    assert work.prefill_flops(m, 16, 1024) == \
        2 * (P - head) * 16 * 1024 + 16 * attn * (1024 * 1025 // 2) \
        + 2 * head * 16
    assert work.decode_flops(m, 16, [1024, 1025]) == \
        2 * (2 * P * 16) + 16 * attn * (1025 + 1026)


def test_kernel_work_and_bounds():
    # flash, the training shape: 4 rows × 512, H 32, Kv 8, Dh 128, lse
    nbytes, flops = work.flash_work(4, 512, 512, 32, 8, 128,
                                    work.causal_pairs(512), with_lse=True)
    assert nbytes == (2 * 4 * 512 * 32 * 128 + 2 * 4 * 512 * 8 * 128) * 2 \
        + 4 * 512 * 32 * 4
    assert flops == 4 * 4 * 32 * 128 * 131_328
    ms, what = work.bound_ms(nbytes, flops, "bfloat16")
    assert what == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)
    # decode: B 16, 1025 valid slots of an 8-head cache
    nbytes, flops = work.decode_work(16, 32, 8, 128, 1025)
    assert nbytes == (2 * 16 * 1025 * 8 * 128 + 2 * 16 * 32 * 128) * 2 + 4
    assert flops == 4 * 16 * 32 * 1025 * 128
    # the int8 hop's combine of a 64-padded leaf of both pods
    F = 4096 * 49152
    nbytes, flops = work.combine_work(1, 2, F, 2 * F, n_scales=2 * F // 64)
    assert nbytes == 2 * F + 8 + 4 * F + 4 * (2 * F // 64)
    assert flops == 4 * F + 2 * F
    assert work.bound_ms(1e12, 0, "float32") == (pytest.approx(1e3 / 3.35),
                                                 "bytes")
    assert work.bound_ms(0, 989e12, "bfloat16") == (pytest.approx(1e3),
                                                    "operations")
