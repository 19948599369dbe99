"""Port vs reference: the edge→master codecs, bit for bit.

The same numpy inputs go through ``repro.dist.compression`` and
``repro_torch.dist.compression``: payloads and scales must be EQUAL
(int8, packed int4, fp8-e4m3), with block-multiple and padded sizes;
pack/unpack and the error-feedback telescoping hold in the port too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as rc
from repro_torch.dist import compression as tc

MODES = ["int8", "int4", "fp8"]


def _x(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * scale
    x[rng.random(n) < 0.05] = 0.0  # exact zeros and an all-zero region
    x[: min(n, 64)] = 0.0
    return x


def _bits(a):
    """Payload as raw bytes (fp8 has no numpy dtype of its own)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,block", [(4096, 64), (1000, 64), (777, 256),
                                     (130, 128), (64 * 31 + 2, 64)])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_payload_and_scales_bit_for_bit(mode, n, block, scale):
    x = _x(n + block, n, scale).reshape(-1)
    rq, rs, rmeta = rc.quantize(jnp.asarray(x), block=block, mode=mode)
    q, s, meta = tc.quantize(torch.from_numpy(x), block=block, mode=mode)
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert (meta.shape, meta.block, meta.pad, meta.mode) == (
        rmeta.shape, rmeta.block, rmeta.pad, rmeta.mode)
    np.testing.assert_array_equal(
        tc.dequantize(q, s, meta).numpy(),
        np.asarray(rc.dequantize(rq, rs, rmeta)))


@pytest.mark.parametrize("mode", MODES)
def test_leaf_shapes_round_trip_through_the_flat_payload(mode):
    x = _x(1, 6 * 37).reshape(6, 37)
    q, s, meta = tc.quantize(torch.from_numpy(x), block=32, mode=mode)
    assert meta.shape == (6, 37) and meta.pad == (-6 * 37) % 32
    rq, rs, _ = rc.quantize(jnp.asarray(x), block=32, mode=mode)
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    back = tc.dequantize(q, s, meta)
    assert back.shape == (6, 37)
    tol = {"int8": 1 / 127, "int4": 1 / 7, "fp8": 1 / 8}[mode]
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        tol * float(np.abs(x).max()) * 0.51 + 1e-7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int4_pack_unpack(seed):
    vals = np.random.default_rng(seed).integers(-8, 8, 2 * 300)
    packed = tc.pack_int4(torch.from_numpy(vals))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(rc.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tc.unpack_int4(packed).numpy(), vals)


def test_pad_is_masked_out_and_quantizes_to_zero():
    x = np.full(65, 3.0, np.float32)
    for mode in MODES:
        q, s, meta = tc.quantize(torch.from_numpy(x), block=64, mode=mode)
        vals = (tc.unpack_int4(q) if mode == "int4"
                else q.to(torch.float32))
        assert float(vals.reshape(-1)[65:].abs().sum()) == 0.0
        assert s[1] == np.float32(3.0) / tc._QMAX[mode]


def test_block_and_mode_errors():
    with pytest.raises(ValueError, match="even block"):
        tc.quantize(torch.ones(8), block=3, mode="int4")
    with pytest.raises(ValueError, match="unknown compression mode"):
        tc.quantize(torch.ones(8), block=4, mode="int2")
    assert tc.wire_bytes_per_value("int4", 64) == rc.wire_bytes_per_value(
        "int4", 64)


@pytest.mark.parametrize("mode", MODES)
def test_error_feedback_matches_reference_and_telescopes(mode):
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((5, 40)).astype(np.float32),
         "b": {"c": rng.standard_normal(70).astype(np.float32)}}
    tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
        g["b"]["c"])}}
    r = tc.init_pod_residuals(tg, 1)
    r = {"a": r["a"][0], "b": {"c": r["b"]["c"][0]}}
    jr = {"a": jnp.zeros((5, 40)), "b": {"c": jnp.zeros(70)}}
    jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
    sent_sum = {"a": torch.zeros(5, 40), "b": {"c": torch.zeros(70)}}
    T = 6
    for _ in range(T):
        q, r = tc.compress_error_feedback(tg, r, block=32, mode=mode)
        jq, jr = rc.compress_error_feedback(jg, jr, block=32, mode=mode)
        np.testing.assert_array_equal(_bits(q["a"]["q"]),
                                      _bits(jq["a"]["q"]))
        np.testing.assert_array_equal(r["b"]["c"].numpy(),
                                      np.asarray(jr["b"]["c"]))
        sent = tc.dequantize_tree(q, tg)
        sent_sum["a"] += sent["a"]
        sent_sum["b"]["c"] += sent["b"]["c"]
    # Σ_t sent_t = T·g − r_T
    torch.testing.assert_close(sent_sum["a"] + r["a"], T * tg["a"],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sent_sum["b"]["c"] + r["b"]["c"],
                               T * tg["b"]["c"], rtol=1e-5, atol=1e-5)
