"""The hand-written Hopper kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the check
runs inside a fixture, so every pytest worker collects the same tests).
On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py``.  Tolerances: 1e-4 in float32 (only
the summation order differs), 2e-2 in bfloat16 (one output rounding);
the coded-combine kernels 1e-5 of each output row's max |plain|; the
MoE shuffle kernels as :func:`test_moe_shuffle_kernels_match_plain`
states.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch._tree import leaves as ops_leaves
from repro_torch.dist import compression
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models import moe as moe_lib

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _launches(kernel: str) -> int:
    return ops.launch_counts()[kernel]


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
        before = _launches("decode_attention")
        got = decode_attention_fwd(q, k, v, pos, window=window,
                                   softcap=softcap)
        assert _launches("decode_attention") == before + 1
        want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                        softcap=softcap)
        tol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    head_dims = [16, 32, 64, 128, 256]
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


def _worst_row(got, want):
    """Worst output row's max |got - want| over that row's max |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(-1)
            / want.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("pos_kind", ["empty", "wrapped"])
def test_decode_kernel_split_sweep_at_the_serve_shape(pos_kind):
    """The split sweep at llama3-8b's serving shape (bf16, a view of the
    decode cache's (B, C, Kv·Dh) buffer): q_pos = 0 leaves every split but
    the first without a valid slot; the wrapped position fills them all."""
    from repro_torch.kernels.decode_attention import split_plan

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, C, Kv, G, Dh = 4, 1057, 8, 4, 128
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, chunk = split_plan(C, B * Kv, n_sm)
    assert n_split > 1 and (n_split - 1) * chunk < C <= n_split * chunk
    pos = {"empty": 0, "wrapped": 2 * C + 3}[pos_kind]
    q = _randn(gen, B, 1, Kv * G, Dh, dtype=torch.bfloat16)
    k = _randn(gen, B, C, Kv * Dh, dtype=torch.bfloat16).view(B, C, Kv, Dh)
    v = _randn(gen, B, C, Kv * Dh, dtype=torch.bfloat16).view(B, C, Kv, Dh)
    qp = torch.tensor(pos, dtype=torch.int32, device="cuda")
    for _ in range(3):  # the merge counters must be left at zero
        got = decode_attention_fwd(q, k, v, qp)
        want = ref.decode_attention_ref(q, k, v, qp)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        assert _worst_row(got, want) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_cross_attention_matches_plain(dtype):
    """Non-causal attention of S queries over T ≠ S keys (whisper's
    cross-attention over its encoder's 1500 frames), at G 1 and 6, with
    the log-sum-exp the training forward saves."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    tol = TOLS[dtype]
    grid = itertools.product([1, 64, 1000], [17, 1500], [1, 6], [64, 128])
    for S, T, G, Dh in grid:
        q = _randn(gen, 2, S, 2 * G, Dh, dtype=dtype)
        k = _randn(gen, 2, T, 2, Dh, dtype=dtype)
        v = _randn(gen, 2, T, 2, Dh, dtype=dtype)
        got, lse = flash_attention_fwd(q, k, v, causal=False,
                                       return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, causal=False,
                                                 return_lse=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_over_a_full_cross_cache(dtype):
    """whisper's cross decode: every slot of a 1500-slot cache valid at
    q_pos = C − 1 (an int32 device scalar), H = Kv = 16, Dh 64, batch 4:
    the plain attention over all frames."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, C, Kv, Dh = 4, 1500, 16, 64
    q = _randn(gen, B, 1, Kv, Dh, dtype=dtype)
    k = _randn(gen, B, C, Kv * Dh, dtype=dtype).view(B, C, Kv, Dh)
    v = _randn(gen, B, C, Kv * Dh, dtype=dtype).view(B, C, Kv, Dh)
    qp = torch.tensor(C - 1, dtype=torch.int32, device="cuda")
    got = decode_attention_fwd(q, k, v, qp)
    from repro_torch.models import attention as attn_lib

    want = attn_lib.dense_attention(
        q, k, v, torch.zeros(1, device="cuda"),
        torch.zeros(C, device="cuda"), causal=False)
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(q, k, v, qp).float(),
        rtol=tol, atol=tol)


def _flash_case(gen, case, Dh):
    """(q, k, v, return_lse) of one wgmma-kernel case, bf16, G = 4."""
    B, S, Kv, G = 2, 1000, 2, 4
    if case == "strided":  # q a batch-strided view of a larger buffer
        S = 256
        big = _randn(gen, 2 * B, S, Kv * G, Dh, dtype=torch.bfloat16)
        q = big[::2]
        assert not q.is_contiguous()
    else:
        q = _randn(gen, B, S, Kv * G, Dh, dtype=torch.bfloat16)
    k = _randn(gen, B, S, Kv, Dh, dtype=torch.bfloat16)
    v = _randn(gen, B, S, Kv, Dh, dtype=torch.bfloat16)
    return q, k, v, case == "lse"


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("case", ["ragged", "strided", "lse"])
def test_flash_wgmma_kernel_matches_plain(case, Dh):
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, with_lse = _flash_case(gen, case, Dh)
    for causal, window, softcap in ((True, 0, 0.0), (True, 100, 30.0),
                                    (False, 0, 0.0)):
        got = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap, return_lse=with_lse)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       return_lse=with_lse)
        if with_lse:
            (got, lse), (want, want_lse) = got, want
            torch.testing.assert_close(lse, want_lse, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        assert _worst_row(got, want) <= 2e-2, (case, Dh, causal, window)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 4, 48, device="cuda")
    with pytest.raises(ValueError, match="Dh"):
        flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 4, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh"):
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
    c, g = torch.randn(1, 2, device="cuda"), torch.randn(2, 128,
                                                        device="cuda")
    ops.combine(c, g)
    ops.combine(c.cpu(), g.cpu())
    for mode in ("int8", "int4", "fp8"):
        q8, s8, _ = compression.quantize(g[0], block=64, mode=mode)
        qs, ss = torch.stack([q8, q8]), torch.stack([s8, s8])
        ops.combine_compressed(mode, c, qs, ss, block=64)
        ops.combine_compressed(mode, c.cpu(), qs.cpu(), ss.cpu(), block=64)
    for dev in ("cuda", "cpu"):
        x, plan = _moe_case(torch.Generator(device="cuda").manual_seed(2),
                            *MOE_SHAPES["decode"], torch.float32)
        x, plan = x.to(dev), _plan_to(plan, dev)
        w = torch.rand(plan.slot_tk.shape, device=dev)
        ops.moe_combine(ops.moe_dispatch(x, plan), w, plan)
    assert ops.launch_counts() == {
        "decode_attention": 1, "flash_attention": 1, "coded_combine": 1,
        "coded_combine_q": 1, "coded_combine_q4": 1, "coded_combine_f8": 1,
        "moe_dispatch": 1, "moe_combine": 1, "moe_dispatch_bwd": 0,
        "moe_combine_bwd": 0}


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


def _combine_case(gen, kind, R, K, F, block):
    """(coeff, payload, scales) on the card, the payload as the codec
    lays it out (F values per row; int4 packs two per byte)."""
    c = torch.randn(R, K, generator=gen, device="cuda")
    if kind == "f32":
        return c, torch.randn(K, F, generator=gen, device="cuda"), None
    scales = torch.rand(K, F // block, generator=gen, device="cuda") + 0.1
    if kind == "int8":
        q = torch.randint(-127, 128, (K, F), generator=gen, device="cuda",
                          dtype=torch.int8)
    elif kind == "int4":
        q = torch.randint(-128, 128, (K, F // 2), generator=gen,
                          device="cuda", dtype=torch.int8)
    else:
        q = (torch.randn(K, F, generator=gen, device="cuda") * 100).clamp(
            -448, 448).to(torch.float8_e4m3fn)  # e4m3 has no inf
    return c, q, scales


_KERNEL = {"f32": "coded_combine", "int8": "coded_combine_q",
           "int4": "coded_combine_q4", "fp8": "coded_combine_f8"}
_PLAIN = {"f32": "coded_combine_ref", "int8": "coded_combine_q_ref",
          "int4": "coded_combine_q4_ref", "fp8": "coded_combine_f8_ref"}


@pytest.mark.parametrize("kind", ["f32", "int8", "int4", "fp8"])
def test_coded_combine_kernels_match_plain(kind):
    from repro_torch.kernels import coded_combine as cc

    gen = torch.Generator(device="cuda").manual_seed(2)
    kernel = getattr(cc, _KERNEL[kind])
    plain = getattr(ref, _PLAIN[kind])
    # F = 4162 with block 2: unaligned rows (scalar path), one scale per
    # value; F = 64: shorter than one block of threads
    grid = itertools.product([1, 8, 13], [2, 8, 64],
                             [(64, 64), (4160, 64), (4224, 128),
                              (4096, 256), (4162, 2), (2 ** 16 + 64, 64)])
    for R, K, (F, block) in grid:
        c, q, s = _combine_case(gen, kind, R, K, F, block)
        before = _launches(_KERNEL[kind])
        got = kernel(c, q) if kind == "f32" else kernel(c, q, s, block=block)
        assert _launches(_KERNEL[kind]) == before + 1
        want = plain(c, q) if kind == "f32" else plain(c, q, s, block)
        assert got.shape == want.shape == (R, F)
        row_max = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        worst = ((got - want).abs() / row_max).max().item()
        assert worst <= 1e-5, (kind, R, K, F, block, worst)


def test_coded_combine_wrappers_reject_what_the_kernel_does_not_take():
    from repro_torch.kernels import coded_combine as cc

    c = torch.ones(1, 2, device="cuda")
    with pytest.raises(ValueError, match="block"):
        cc.coded_combine_q(c, torch.zeros(2, 100, dtype=torch.int8,
                                          device="cuda"),
                           torch.ones(2, 1, device="cuda"), block=64)
    with pytest.raises(ValueError, match="payload must be"):
        cc.coded_combine_q(c, torch.zeros(2, 64, device="cuda"),
                           torch.ones(2, 1, device="cuda"), block=64)
    with pytest.raises(ValueError, match="CUDA"):
        cc.coded_combine(c.cpu(), torch.zeros(2, 8))


def test_flash_lse_and_training_backward_match_cpu():
    from repro_torch.models import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(3)
    for S, window, softcap in ((64, 0, 0.0), (100, 16, 30.0)):
        q = _randn(gen, 2, S, 8, 32, dtype=torch.float32)
        k = _randn(gen, 2, S, 2, 32, dtype=torch.float32)
        v = _randn(gen, 2, S, 2, 32, dtype=torch.float32)
        do = _randn(gen, 2, S, 8, 32, dtype=torch.float32)
        out, lse = flash_attention_fwd(q, k, v, window=window,
                                       softcap=softcap, return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=window,
                                                 softcap=softcap,
                                                 return_lse=True)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_(True)
                      for t in (q, k, v)]
            attn.flash_attention(*leaves, True, window, softcap,
                                 32).backward(do.to(dev))
            grads.append([t.grad.cpu() for t in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _params_off(card, cpu, init):
    """Values of the trained params where the card's run and the CPU's
    differ by more than 1e-4 of the leaf's largest change since ``init``
    plus two float32 spacings of the value: ``(count, of all)``."""
    off = total = 0
    for key, want in cpu.items():
        tol = (1e-4 * np.abs(want - init[key]).max()
               + 2 * np.spacing(np.abs(want)))
        off += int((np.abs(card[key] - want) > tol).sum())
        total += want.size
    return off, total


def test_coded_q_session_on_the_card_matches_cpu_and_counts_launches():
    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
    from repro_torch.checkpoint.params import params_to_numpy
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    init = params_to_numpy(tf.init_params(cfg, device="cpu",
                                          dtype=torch.float32))
    for codec, name in (("int8", "coded_combine_q"),
                        ("int4", "coded_combine_q4"),
                        ("fp8", "coded_combine_f8")):
        losses, trained = {}, {}
        for dev in ("cpu", "cuda"):
            s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                             planner=planner_for_scheme("hgc", 1, 1),
                             mode="coded_q", grad_compression=codec,
                             seq_len=16, optimizer="sgd", lr=0.05,
                             total_steps=3, verbose=False, params=init,
                             device=dev)
            ops.reset_launch_counts()
            losses[dev] = s.fit(3)["losses"]
            trained[dev] = params_to_numpy(s.params)
            if dev == "cuda":
                counts = ops.launch_counts()
                assert counts[name] == 3 * len(ops_leaves(s.params))
                # 8 groups x layers, each forward run twice (remat)
                assert counts["flash_attention"] == 3 * 8 * cfg.n_layers * 2
        np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                                   rtol=2e-3, atol=0)
        # A wrong decode (a wrong λ, a dropped pod, no update) moves most
        # values by a share of their change.  Where the card's and the
        # CPU's partial differ by an ulp, a value may round to the next
        # code; error feedback carries that back, so it stays rare.
        off, total = _params_off(trained["cuda"], trained["cpu"], init)
        assert off <= 1e-3 * total, (codec, off, total)


def test_kill_resume_on_the_card_is_bit_for_bit(tmp_path):
    """A small float32 coded_q int8 session on the card, killed after a
    checkpoint at step 2 and resumed, equals an uninterrupted card run:
    losses, and the trained params, optimizer state and EF residuals."""
    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
    from repro_torch.checkpoint.params import _flatten
    from repro_torch.configs.registry import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    kw = dict(planner=planner_for_scheme("hgc", 1, 1), mode="coded_q",
              grad_compression="int8", seq_len=16, optimizer="adamw",
              total_steps=4, verbose=False, device="cuda")
    fit = dict(force_drop_edge=1, force_drop_step=2)

    def state(s):
        flat = _flatten({"params": s.params, "opt_state": s.opt_state,
                         "residual": s.residual})
        return {k: v.detach().cpu() for k, v in flat.items()}

    whole = CodedSession(CodedCluster.homogeneous(2, 4), cfg, **kw)
    whole.fit(4, **fit)
    ck = str(tmp_path / "ck")
    killed = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                          checkpoint_dir=ck, checkpoint_every=2, **kw)
    killed.fit(4, stop_after=2, **fit)
    resumed = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                           checkpoint_dir=ck, resume=True, **kw)
    assert resumed._step == 2 and resumed.params["embed"]["table"].is_cuda
    resumed.fit(4, **fit)
    assert killed.losses + resumed.losses == whole.losses
    a, b = state(whole), state(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("F,stride", [(7850, 7850), (7850, 7852),
                                      (845738, 845738), (845738, 845740)],
                         ids=["logreg-packed", "logreg-padded",
                              "cnn-packed", "cnn-padded"])
def test_coded_combine_at_the_evaluation_shape(F, stride):
    """R = 1, K = 40: the simulator's decode.  A packed row stride of F
    floats is not 16-byte aligned (the scalar path); the padded one is."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(40, stride, generator=gen, device="cuda")[:, :F]
    c = torch.randn(1, 40, generator=gen, device="cuda")
    before = _launches("coded_combine")
    got = ops.combine(c, g)
    assert _launches("coded_combine") == before + 1
    want = ref.coded_combine_ref(c, g)
    worst = ((got - want).abs().amax() / want.abs().amax()).item()
    assert worst <= 1e-5, worst


def test_simulate_training_on_the_card_matches_cpu():
    """The logistic regression under greedy and the CNN under hgc, three
    iterations on the card and on the CPU from the same weights: equal
    times, losses within 2e-3·|loss|, accuracies within 2 / n_eval, one
    combine launch per iteration."""
    from repro_torch.api import paper_cluster, simulate_training
    from repro_torch.models import classic

    for name, dataset, init in (("greedy", "mnist", classic.init_logreg),
                                ("hgc", "cifar", classic.init_cnn)):
        kw = dict(dataset=dataset, K=40, iters=3, batch_per_part=4,
                  n_data=800, n_eval=100, eval_every=1,
                  init_params=init(0))
        ops.reset_launch_counts()
        card = simulate_training(name, paper_cluster(dataset),
                                 device="cuda", **kw)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {"coded_combine": 3}
        cpu = simulate_training(name, paper_cluster(dataset), device="cpu",
                                **kw)
        np.testing.assert_array_equal(card.iter_times_ms, cpu.iter_times_ms)
        assert np.isfinite(card.losses).all()
        np.testing.assert_allclose(card.losses, cpu.losses, rtol=2e-3)
        assert np.abs(card.accuracies - cpu.accuracies).max() <= 2 / 100


@pytest.mark.parametrize("K", [1, 13, 40, 64, 200])
@pytest.mark.parametrize("R", [1, 8, 13])
def test_coded_combine_f32_at_its_edges(R, K):
    """The f32 kernel's own edges: R within and past one tile of 8 rows
    of C; K below its 4-row unroll, not a multiple of it (1, 13) and
    far past it; F below one thread's 4 columns (3), below one warp's
    (64) and not a multiple of 4 (4162, 845,738); rows packed (every
    odd row 8 bytes off a 16-byte boundary: scalar loads) and padded to
    16 bytes (vector loads); every output row within 1e-5 of its max
    |plain|."""
    from repro_torch.kernels import coded_combine as cc

    gen = torch.Generator(device="cuda").manual_seed(6)
    for F, padded in itertools.product([3, 64, 4162, 845738],
                                       [False, True]):
        if F == 845738 and R * K > 320:
            continue  # the evaluation's width at its own K; keeps it short
        g = torch.randn(K, -(-F // 4) * 4 if padded else F, generator=gen,
                        device="cuda")[:, :F]
        c = torch.randn(R, K, generator=gen, device="cuda")
        before = _launches("coded_combine")
        got = cc.coded_combine(c, g)
        assert _launches("coded_combine") == before + 1
        want = ref.coded_combine_ref(c, g)
        row_max = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        worst = ((got - want).abs() / row_max).max().item()
        assert worst <= 1e-5, (R, K, F, padded, worst)


def test_simulate_training_on_the_card_repeats_bit_for_bit(monkeypatch):
    """Two card runs of the CNN under hgc from the same seed and weights
    give equal losses and accuracies, bit for bit, whatever the caller's
    cuDNN flags (here TF32 on, benchmarking, not deterministic), which
    the runs leave as they found them."""
    from repro_torch.api import paper_cluster, simulate_training
    from repro_torch.models import classic

    caller = dict(allow_tf32=True, benchmark=True, deterministic=False)
    for name, value in caller.items():
        monkeypatch.setattr(torch.backends.cudnn, name, value)
    kw = dict(dataset="cifar", K=40, iters=4, batch_per_part=8,
              n_data=800, n_eval=100, eval_every=1, seed=3,
              init_params=classic.init_cnn(3))
    a = simulate_training("hgc", paper_cluster("cifar"), device="cuda", **kw)
    b = simulate_training("hgc", paper_cluster("cifar"), device="cuda", **kw)
    assert np.isfinite(a.losses).all()
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.accuracies, b.accuracies)
    for name, value in caller.items():
        assert getattr(torch.backends.cudnn, name) == value


# a rank's attention shapes under tensor parallelism: llama3-8b at tp 2
# (H 16 over Kv 4) and starcoder2-3b at tp 4 (H 6 over its one
# replicated KV head), batch 4, Dh 128
TP_RANK_SHAPES = [(16, 4), (6, 1)]


@pytest.mark.parametrize("H,Kv", TP_RANK_SHAPES,
                         ids=[f"H{h}-Kv{k}" for h, k in TP_RANK_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernels_at_a_tp_rank_shapes(H, Kv, dtype):
    gen = torch.Generator(device="cuda").manual_seed(5)
    tol = TOLS[dtype]
    for S, lse in ((1024, False), (512, True)):  # prefill; training
        q = _randn(gen, 4, S, H, 128, dtype=dtype)
        k = _randn(gen, 4, S, Kv, 128, dtype=dtype)
        v = _randn(gen, 4, S, Kv, 128, dtype=dtype)
        got = flash_attention_fwd(q, k, v, causal=True, return_lse=lse)
        want = ref.flash_attention_ref(q, k, v, causal=True, return_lse=lse)
        if lse:
            torch.testing.assert_close(got[1], want[1], rtol=tol, atol=tol)
            got, want = got[0], want[0]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    C = 1024 + 32 + 1  # the served prompt, 32 tokens and one slot
    for pos in (1024 + 16, 2 * C + 3):  # mid-generation; a wrapped ring
        q = _randn(gen, 4, 1, H, 128, dtype=dtype)
        k = _randn(gen, 4, C, Kv, 128, dtype=dtype)
        v = _randn(gen, 4, C, Kv, 128, dtype=dtype)
        got = decode_attention_fwd(q, k, v, pos)
        want = ref.decode_attention_ref(q, k, v, pos)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# ----------------------------------------------------------------------
# the MoE shuffle kernels (csrc/moe_shuffle.cu) through their autograd
# Functions, against the plain version (kernels.ref) on the same tensors
# ----------------------------------------------------------------------
#: (N tokens, k, E, this rank's expert block (e0, E_local), capacity
#: factor, d): granite-moe's training group; rank 1 of two at tp 2 (its
#: 20 experts of 40: the others' entries dropped); its decode step (N =
#: the batch, cap 1); llama4-maverick's top-1 of 128 experts at d 5,120
MOE_SHAPES = {
    "cell": (16384, 8, 40, (0, 40), 1.25, 1536),
    "tp": (4096, 8, 40, (20, 20), 1.25, 1536),
    "decode": (4, 8, 40, (0, 40), 1.25, 1536),
    "maverick": (4096, 1, 128, (0, 128), 1.25, 5120),
}


def _moe_case(gen, N, k, E, block, cf, d, dtype):
    """Tokens (N, d) and the plan of a random routing, made on the card:
    k distinct experts a token, drawn with logits rising by 1.5 from the
    first expert to the last (Gumbel top-k), which drops 8–10% of the
    entries at capacity factor 1.25, as the trained cell's routing does."""
    e0, E_local = block
    u = torch.rand(N, E, generator=gen, device="cuda")
    logits = torch.linspace(0.0, 1.5, E, device="cuda")
    top_e = (logits - torch.log(-torch.log(u))).argsort(
        -1, descending=True)[:, :k]
    cap = moe_lib.capacity(N, k, E, cf)
    order, slot, _ = moe_lib.dispatch_slots(top_e, E, cap, e0, E_local)
    plan = moe_lib.shuffle_plan(order, slot, k, E_local * cap)
    return _randn(gen, N, d, dtype=dtype), plan


def _plan_to(plan, dev):
    return plan._replace(**{f: getattr(plan, f).to(dev)
                            for f in ("order", "slot", "slot_tk", "src")})


def _moe_passes(x, plan, rows, w, dbuf, dy, plain):
    """The four passes through autograd: → (buf, y, dx, dout, dw)."""
    x, rows, w = (t.detach().requires_grad_(True) for t in (x, rows, w))
    if plain:
        buf = ref.moe_dispatch_ref(x, plan.order, plan.slot,
                                   plan.src.numel(), plan.top_k)
        y = ref.moe_combine_ref(rows, w, plan.order, plan.slot)
    else:
        buf = ops.moe_dispatch(x, plan)
        y = ops.moe_combine(rows, w, plan)
    (dx,) = torch.autograd.grad(buf, x, dbuf)
    dout, dw = torch.autograd.grad(y, [rows, w], dy)
    return buf, y, dx, dout, dw


def _moe_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, plan = _moe_case(gen, *MOE_SHAPES[shape], dtype)
    n_slots, d = plan.src.numel(), x.shape[-1]
    rows = _randn(gen, n_slots, d, dtype=dtype)
    w = torch.rand(plan.slot_tk.shape, generator=gen, device="cuda")
    dbuf = _randn(gen, n_slots, d, dtype=dtype)
    dy = _randn(gen, x.shape[0], d, dtype=dtype)
    return x, plan, rows, w, dbuf, dy


def _close(got, want, rtol, share, what):
    """``got`` within ``rtol`` of each value and ``share`` of the largest
    |want| (float32 comparison)."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=share * want.abs().max().item() + 1e-30,
                               msg=what)


@pytest.mark.parametrize("shape", list(MOE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_shuffle_kernels_match_plain(shape, dtype):
    """Tolerances.  The dispatch copies: equal.  float32: the kernels sum
    a token's k rows (and the weight's gradient over d) in another order
    than PyTorch's reductions, rtol 1e-5 and 1e-6 of the largest value;
    the combine's backward ``w · dy`` is one product in both: equal.
    bfloat16: each kernel computes in float32 and rounds once, so
    against the plain version run in float32 on the same (upcast)
    inputs it is within one bf16 rounding, rtol 2^-8; against the plain
    version in bf16, which rounds the weight and each product to bf16
    before its sum, within 2% of the largest value (``dw``: the plain
    version rounds its products and its sum to bf16)."""
    x, plan, rows, w, dbuf, dy = _moe_inputs(shape, dtype, seed=11)
    before = ops.launch_counts()
    got = _moe_passes(x, plan, rows, w, dbuf, dy, plain=False)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in (
        "moe_dispatch", "moe_combine", "moe_dispatch_bwd",
        "moe_combine_bwd")} == dict.fromkeys(
        ("moe_dispatch", "moe_combine", "moe_dispatch_bwd",
         "moe_combine_bwd"), 1)
    plain = _moe_passes(x, plan, rows, w, dbuf, dy, plain=True)
    names = ("buf", "y", "dx", "dout", "dw")
    for name, a, b in zip(names, got, plain):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    assert torch.equal(got[0], plain[0])
    dropped = plan.slot_tk < 0
    assert (got[4][dropped] == 0).all()
    assert (got[0][plan.src < 0] == 0).all()
    assert (got[3][plan.src < 0] == 0).all()
    if shape != "decode":
        assert dropped.any() and (plan.src < 0).any()
    if dtype == torch.float32:
        assert torch.equal(got[3], plain[3])
        for name, a, b in zip(names[1:], got[1:], plain[1:]):
            _close(a, b, 1e-5, 1e-6, name)
        return
    up = [t.float() for t in (x, rows, w, dbuf, dy)]
    exact = _moe_passes(up[0], plan, *up[1:], plain=True)
    for name, a, b, c in zip(names[1:], got[1:], exact[1:], plain[1:]):
        if name == "dw":  # float32 output, bf16 products: exact in f32
            _close(a, b, 1e-5, 1e-6, name)
        else:
            _close(a, b, 2 ** -8, 1e-6, name)
        _close(a, c, 2e-2, 2e-2, name)


def test_moe_shuffle_kernels_repeat_bit_for_bit():
    """Two runs of the four passes at the training shape, bf16, equal bit
    for bit: no pass adds into a row from more than one thread group."""
    inputs = _moe_inputs("cell", torch.bfloat16, seed=12)
    a = _moe_passes(*inputs, plain=False)
    b = _moe_passes(*inputs, plain=False)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_moe_shuffle_wrappers_reject_what_the_kernels_do_not_take():
    from repro_torch.kernels import moe_shuffle

    x, plan = _moe_case(torch.Generator(device="cuda").manual_seed(3),
                        *MOE_SHAPES["decode"], torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        moe_shuffle.moe_dispatch(x.half(), plan.slot_tk, plan.src)
    with pytest.raises(ValueError, match="int32"):
        moe_shuffle.moe_dispatch(x, plan.slot_tk, plan.src.long())
    with pytest.raises(ValueError, match="CUDA"):
        moe_shuffle.moe_dispatch(x.cpu(), plan.slot_tk, plan.src)
    with pytest.raises(ValueError, match="tokens"):
        moe_shuffle.moe_dispatch(x[:3], plan.slot_tk, plan.src)
    with pytest.raises(ValueError, match="packed rows"):
        moe_shuffle.moe_combine(x.t(), torch.rand(4, 8, device="cuda"),
                                plan.slot_tk)


def test_moe_coded_step_launches_the_shuffle_kernels_and_no_index_add():
    """One coded_q int8 step of the granite-moe smoke config on the card
    (8 groups, every layer rematerialized): per MoE layer and group two
    forward launches of the dispatch and of the combine (the forward and
    the recompute) and one of each backward, and, under the profiler, no
    ``index_add`` kernel (``indexFunc…``) anywhere in the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
    from repro_torch.configs.registry import get_smoke_config

    cfg = get_smoke_config("granite-moe-3b-a800m")
    n_moe = sum(cfg.moe_at(i) for i in range(cfg.n_layers))
    assert n_moe > 0
    s = CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                     planner=planner_for_scheme("hgc", 1, 1), mode="coded_q",
                     grad_compression="int8", seq_len=16, optimizer="adamw",
                     lr=1e-3, total_steps=2, verbose=False, device="cuda")
    s.fit(1)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.fit(2)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    groups = 8
    assert {k: counts[k] for k in ("moe_dispatch", "moe_combine",
                                   "moe_dispatch_bwd", "moe_combine_bwd")} \
        == {"moe_dispatch": 2 * groups * n_moe,
            "moe_combine": 2 * groups * n_moe,
            "moe_dispatch_bwd": groups * n_moe,
            "moe_combine_bwd": groups * n_moe}
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("moe_gather_dispatch_kernel" in n for n in names)
    assert not [n for n in names if "indexFunc" in n]
