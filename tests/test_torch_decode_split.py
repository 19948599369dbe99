"""The decode kernel's split cache sweep on the CPU: its arithmetic, its plan.

``csrc/decode_attention.cu`` cuts each (sequence, kv head)'s sweep of the
ring-buffer cache into ranges of ``chunk`` slots; each range's block
writes a partial softmax state (m, l, o), a range with no valid slot
writes (-1e30, 0, 0), and the last block to finish merges them.  The
plain chunked version below does that in numpy and is held against the
reference's Pallas kernel (``interpret=True``) within 1e-5 in float32:
both sides compute in f32 and differ only in summation order.  The plan
(``split_plan``) is checked for what the kernel relies on.
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels import decode_attention as port

NEG_INF = -1e30
B, KV, G, DH = 2, 2, 2, 16


@functools.lru_cache(maxsize=None)
def _inputs(C):
    rng = np.random.default_rng(C)
    q = rng.standard_normal((B, 1, KV * G, DH), dtype=np.float32)
    k = rng.standard_normal((B, C, KV, DH), dtype=np.float32)
    v = rng.standard_normal((B, C, KV, DH), dtype=np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _reference(C, pos, window, softcap):
    q, k, v = _inputs(C)
    out = decode_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               pos, window=window, softcap=softcap,
                               interpret=True)
    return np.asarray(out)


def _chunked(q, k, v, pos, window, softcap, n_split):
    """Decode attention as the split kernel computes it: per range of
    ``chunk = ceil(C / n_split)`` slots a partial (m, l, o) in f32, then
    O = Σ e^{m_i − M} o_i / max(Σ e^{m_i − M} l_i, 1e-30),
    M = max m_i."""
    C = k.shape[1]
    weff = window if window > 0 else C
    chunk = -(-C // n_split)
    slots = np.arange(C)
    k_pos = slots + weff * np.floor_divide(pos - slots, weff)
    ok = (k_pos >= 0) & (k_pos <= pos)
    if window > 0:
        ok &= pos - k_pos < window
    qg = q.reshape(B, KV, G, DH) * np.float32(1.0 / np.sqrt(DH))
    s = np.einsum("bkgd,bckd->bkgc", qg, k)  # (B, Kv, G, C)
    if softcap > 0:
        s = np.float32(softcap) * np.tanh(s / np.float32(softcap))
    s = np.where(ok, s, np.float32(NEG_INF)).astype(np.float32)
    parts = []
    for lo in range(0, C, chunk):
        hi = min(C, lo + chunk)
        if not ok[lo:hi].any():  # zero weight in the merge
            parts.append((np.full((B, KV, G, 1), NEG_INF, np.float32),
                          np.zeros((B, KV, G, 1), np.float32),
                          np.zeros((B, KV, G, DH), np.float32)))
            continue
        si = s[..., lo:hi]
        m = si.max(-1, keepdims=True)
        p = np.exp(si - m)
        o = np.einsum("bkgc,bckd->bkgd", p, v[:, lo:hi])
        parts.append((m, p.sum(-1, keepdims=True), o))
    M = np.max([m for m, _, _ in parts], axis=0)
    w = [np.exp(m - M) for m, _, _ in parts]
    num = sum(wi * o for wi, (_, _, o) in zip(w, parts))
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return (num / np.maximum(den, np.float32(1e-30))).reshape(B, 1, KV * G, DH)


@pytest.mark.parametrize("C", [40, 1057])
@pytest.mark.parametrize("n_split", [1, 2, 5, 17])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("pos_kind", ["empty", "partial", "full", "wrapped"])
def test_split_merge_matches_reference_kernel(pos_kind, window, softcap,
                                              n_split, C):
    pos = {"empty": 0, "partial": C // 2 - 1, "full": C - 1,
           "wrapped": 2 * C + 3}[pos_kind]
    q, k, v = _inputs(C)
    got = _chunked(q, k, v, pos, window, softcap, n_split)
    want = _reference(C, pos, window, softcap)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C, n_groups, n_sm", [
    (1057, 32, 132),     # the serving shape: 4 sequences x 8 kv heads
    (40, 32, 132), (1, 4, 132), (4, 1, 132), (32768, 1, 132),
    (1057, 132, 132),    # the groups alone fill the card
    (1057, 256, 132), (1057, 8, 1), (7, 3, 8),
])
def test_split_plan_covers_the_cache(C, n_groups, n_sm):
    n_split, chunk = port.split_plan(C, n_groups, n_sm)
    bounds = [(i * chunk, min(C, (i + 1) * chunk)) for i in range(n_split)]
    assert all(lo < hi for lo, hi in bounds)            # none empty
    assert bounds[0][0] == 0 and bounds[-1][1] == C     # they cover [0, C)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert 1 <= n_split <= port.MAX_SPLIT
    if n_groups >= n_sm:
        assert (n_split, chunk) == (1, C)
    else:
        assert n_split == 1 or chunk % port.SPLIT_ALIGN == 0
        assert n_groups * n_split <= port.BLOCKS_PER_SM * n_sm + n_groups
    # a function of the shapes and the card alone: q_pos cannot reach it
    assert list(inspect.signature(port.split_plan).parameters) == [
        "C", "n_groups", "n_sm"]
    assert port.split_plan(C, n_groups, n_sm) == (n_split, chunk)


def test_split_plan_fills_the_card_at_the_serving_shape():
    n_split, chunk = port.split_plan(1057, 32, 132)
    assert 32 * n_split > 132 and (n_split, chunk) == (9, 128)
