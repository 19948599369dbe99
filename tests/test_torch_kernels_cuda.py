"""The hand-written Hopper kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the check
runs inside a fixture, so every pytest worker collects the same tests).
On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py``.  Tolerances: 1e-4 in float32 (only
the summation order differs), 2e-2 in bfloat16 (one output rounding).
"""
import dataclasses
import itertools

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid = itertools.product(["empty", "partial", "full", "wrapped"],
                             [0, 8], [0.0, 30.0], [1, 2, 8], [1, 8],
                             [16, 32, 64, 128, 256], [4, 40, 1057])
    for pos_kind, window, softcap, G, Kv, Dh, C in grid:
        pos = {"empty": 0, "partial": max(C // 2 - 1, 0), "full": C - 1,
               "wrapped": 2 * C + 3}[pos_kind]
        q = _randn(gen, 2, 1, Kv * G, Dh, dtype=dtype)
        k = _randn(gen, 2, C, Kv, Dh, dtype=dtype)
        v = _randn(gen, 2, C, Kv, Dh, dtype=dtype)
        before = decode_attention_fwd.launches
        got = decode_attention_fwd(q, k, v, pos, window=window,
                                   softcap=softcap)
        assert decode_attention_fwd.launches == before + 1
        want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                        softcap=softcap)
        tol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    head_dims = [16, 32, 64, 128] + ([256] if dtype == torch.float32 else [])
    grid = itertools.product([1, 17, 64, 1000, 1024], [True, False], [0, 16],
                             [0.0, 30.0], [1, 4], head_dims)
    for S, causal, window, softcap, G, Dh in grid:
        q = _randn(gen, 1, S, 2 * G, Dh, dtype=dtype)
        k = _randn(gen, 1, S, 2, Dh, dtype=dtype)
        v = _randn(gen, 1, S, 2, Dh, dtype=dtype)
        got = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
        tol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 4, 48, device="cuda")
    with pytest.raises(ValueError, match="Dh"):
        flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 4, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh <= 128"):
        flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 4, 64, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention_fwd(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    q = torch.zeros(1, 1, 32, 64, device="cuda")
    kc = torch.zeros(1, 8, 1, 64, device="cuda")
    with pytest.raises(ValueError, match="G <= 16"):
        decode_attention_fwd(q, kc, kc, 3)


def test_ops_dispatch_by_device_and_counts():
    ops.reset_launch_counts()
    q = torch.randn(1, 16, 4, 64, device="cuda")
    k = torch.randn(1, 16, 2, 64, device="cuda")
    ops.flash_attention(q, k, k)
    ops.flash_attention(q.cpu(), k.cpu(), k.cpu())
    ops.decode_attention(q[:, :1], k, k, 5)
    ops.decode_attention(q[:, :1].cpu(), k.cpu(), k.cpu(), 5)
    assert ops.launch_counts() == {"decode_attention": 1,
                                   "flash_attention": 1}


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


def test_decode_step_launches_once_per_layer_and_matches_cpu():
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32", n_heads=8, n_kv_heads=2)
    cpu = tf.init_params(cfg, device="cpu")
    gpu = _to_cuda(cpu)
    tokens = torch.randint(0, cfg.vocab, (2, 12))
    ops.reset_launch_counts()
    with torch.inference_mode():
        from repro_torch.api import serving

        lc, cc = serving.make_prefill_fn(cfg, 20)(cpu, tokens)
        lg, cg = serving.make_prefill_fn(cfg, 20)(gpu, tokens.cuda())
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        for step in range(6):
            tok = torch.argmax(lc, -1)[:, None]
            lc, cc = tf.decode_step(cpu, cfg, tok, cc)
            lg, cg = tf.decode_step(gpu, cfg, tok.cuda(), cg)
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert ops.launch_counts()["decode_attention"] == 6 * cfg.n_layers
