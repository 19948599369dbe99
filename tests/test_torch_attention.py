"""Port vs reference: attention functions and the two attention kernels'
CPU dispatch (plain versions), on the same numpy inputs, in float32.

The Pallas kernels run as the reference's own tests run them
(``interpret=True``).  Tolerances are 1e-5: both sides compute in f32
and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline: fixed-example fallback
    from repro._hypothesis_fallback import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_fwd
from repro.kernels.flash_attention import flash_attention_gqa
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B, S, T, Kv, G, Dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Kv * G, Dh), dtype=np.float32)
    k = rng.standard_normal((B, T, Kv, Dh), dtype=np.float32)
    v = rng.standard_normal((B, T, Kv, Dh), dtype=np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def test_rope_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(5, 12)]).astype(np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0)
    _close(got, want)
    # M-RoPE: three position streams over the (2, 3, 3) frequency
    # sections (tests/test_torch_encdec_vlm.py holds more shapes)
    pos3 = np.stack([pos, pos // 2, pos[:, ::-1]]).astype(np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 500_000.0,
                            (2, 3, 3))
    got = tattn.apply_rope(torch.from_numpy(x),
                           torch.from_numpy(np.ascontiguousarray(pos3)),
                           500_000.0, (2, 3, 3))
    _close(got, want)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 8, 30.0), (False, 0, 0.0), (False, 8, 0.0)])
def test_dense_and_size_dispatch_match(causal, window, softcap):
    q, k, v = _qkv(1, 2, 24, 24, 2, 2, 16)
    pos = np.arange(24)
    want = jattn.dense_attention(*map(jnp.asarray, (q, k, v)),
                                 jnp.asarray(pos)[None], jnp.asarray(pos)[None],
                                 causal=causal, window=window, softcap=softcap)
    tq, tk, tv = _t(q, k, v)
    tpos = torch.from_numpy(pos)
    got = tattn.dense_attention(tq, tk, tv, tpos[None], tpos[None],
                                causal=causal, window=window, softcap=softcap)
    _close(got, want)
    # attention(): dense below 2·kv_chunk, chunked above
    for kv_chunk in (16, 8):
        want = jattn.attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                               jnp.asarray(pos), causal=causal, window=window,
                               softcap=softcap, kv_chunk=kv_chunk)
        got = tattn.attention(tq, tk, tv, tpos, tpos, causal=causal,
                              window=window, softcap=softcap,
                              kv_chunk=kv_chunk)
        _close(got, want)


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_chunked_matches(q_chunk):
    q, k, v = _qkv(2, 2, 32, 32, 2, 4, 16)
    pos = np.arange(32)
    want = jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(pos), jnp.asarray(pos),
        causal=True, window=12, softcap=20.0, kv_chunk=8, q_chunk=q_chunk)
    got = tattn.chunked_attention(
        *_t(q, k, v), torch.from_numpy(pos), torch.from_numpy(pos),
        causal=True, window=12, softcap=20.0, kv_chunk=8, q_chunk=q_chunk)
    _close(got, want)


def _decode_case(B, C, Kv, G, Dh, pos_kind, seed):
    pos = {"empty": 0, "partial": max(C // 2 - 1, 0), "full": C - 1,
           "wrapped": 2 * C + 3}[pos_kind]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Kv * G, Dh), dtype=np.float32)
    kc = rng.standard_normal((B, C, Kv, Dh), dtype=np.float32)
    vc = rng.standard_normal((B, C, Kv, Dh), dtype=np.float32)
    return pos, q, kc, vc


def test_ring_slots_and_decode_attention_match():
    B, C, Kv, G, Dh = 2, 16, 2, 2, 16
    for pos in (0, 5, 15, 37):
        for window in (0, 8):
            weff = window or C
            want_pos = jattn.ring_slot_positions(C, jnp.asarray(pos + 1), weff)
            got_pos = tattn.ring_slot_positions(C, torch.tensor(pos + 1), weff)
            np.testing.assert_array_equal(got_pos.numpy(),
                                          np.asarray(want_pos))
            _, q, kc, vc = _decode_case(B, C, Kv, G, Dh, "full", pos)
            want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                          pos, want_pos, window=window,
                                          softcap=30.0)
            got = tattn.decode_attention(*_t(q, kc, vc), torch.tensor(pos),
                                         got_pos, window=window,
                                         softcap=30.0)
            _close(got, want)


@settings(max_examples=20, deadline=None)
@given(
    B=st.integers(1, 3),
    C=st.sampled_from([4, 16, 40]),
    Kv=st.sampled_from([1, 2, 4]),
    G=st.sampled_from([1, 2, 8]),
    Dh=st.sampled_from([16, 64]),
    pos_kind=st.sampled_from(["empty", "partial", "full", "wrapped"]),
    window=st.sampled_from([0, 8]),
    softcap=st.sampled_from([0.0, 30.0]),
    seed=st.integers(0, 1000),
)
def test_ops_decode_attention_matches_pallas_and_ref(
        B, C, Kv, G, Dh, pos_kind, window, softcap, seed):
    pos, q, kc, vc = _decode_case(B, C, Kv, G, Dh, pos_kind, seed)
    jq, jk, jv = map(jnp.asarray, (q, kc, vc))
    want_kernel = decode_attention_fwd(jq, jk, jv, pos, window=window,
                                       softcap=softcap, interpret=True)
    k_pos = jattn.ring_slot_positions(C, pos + 1, window or C)
    want_ref = jref.decode_attention_ref(jq, jk, jv, pos, k_pos,
                                         window=window, softcap=softcap)
    tq, tk, tv = _t(q, kc, vc)
    # q_pos as the decode cache carries it: an int32 tensor
    got = ops.decode_attention(tq, tk, tv, torch.tensor(pos, dtype=torch.int32),
                               window=window, softcap=softcap)
    _close(got, want_kernel)
    _close(got, want_ref)
    _close(tref.decode_attention_ref(tq, tk, tv, pos, window=window,
                                     softcap=softcap), want_ref)


@settings(max_examples=8, deadline=None)
@given(
    seed=st.integers(0, 100),
    B=st.integers(1, 2),
    S=st.sampled_from([32, 64]),
    Kv=st.sampled_from([1, 2]),
    G=st.sampled_from([1, 2, 4]),
    causal=st.booleans(),
    window=st.sampled_from([0, 16]),
)
def test_ops_flash_attention_matches_pallas(seed, B, S, Kv, G, causal,
                                            window):
    q, k, v = _qkv(seed, B, S, S, Kv, G, 32)
    want = flash_attention_gqa(*map(jnp.asarray, (q, k, v)), causal=causal,
                               window=window, interpret=True)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    _close(got, want)


@pytest.mark.parametrize("S", [16, 40])
def test_ops_flash_attention_matches_model_flash(S):
    """Softcap and window, GQA, ragged S: the model's flash function."""
    q, k, v = _qkv(3, 2, S, S, 2, 4, 16)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), True, 8, 30.0,
                                 8, 0)
    got = ops.flash_attention(*_t(q, k, v), causal=True, window=8,
                              softcap=30.0)
    _close(got, want)
