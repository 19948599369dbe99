"""Port vs reference: the dense transformer on the same weights.

The reference initializes the weights; the port loads them through the
flat-key layout (``checkpoint.params.params_from_numpy``).  Everything
runs in float32 on the CPU, so the port takes the kernels' plain
versions.  Tolerances: 1e-4 on logits (f32, summation order and the
dense/chunked split differ), 2e-4 where the reference's own serving
tests use it (bulk vs exact handoff).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import transformer as jtf
from repro_torch.api import serving
from repro_torch.checkpoint.params import params_from_numpy, params_to_numpy
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import transformer as ttf

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(gqa: bool):
    ref = dataclasses.replace(ref_smoke("llama3-8b"), dtype="float32")
    mine = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    if gqa:
        ref = dataclasses.replace(ref, n_heads=8, n_kv_heads=2)
        mine = dataclasses.replace(mine, n_heads=8, n_kv_heads=2)
    return ref, mine


def _setup(gqa: bool, seed: int = 0):
    ref_cfg, cfg = _cfgs(gqa)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return ref_cfg, cfg, jparams, params_from_numpy(flat, "cpu")


def _tokens(seed, B, S, V):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize("gqa", [False, True], ids=["mqa", "gqa"])
def test_forward_logits_and_prefill_cache_match(gqa):
    ref_cfg, cfg, jparams, params = _setup(gqa)
    toks = _tokens(1, 2, 40, cfg.vocab)
    jlogits, _ = jtf.forward(jparams, ref_cfg, jnp.asarray(toks))
    logits, aux = ttf.forward(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert aux.dtype == torch.float32 and float(aux) == 0.0  # dense

    jl, jcache = jtf.prefill(jparams, ref_cfg, jnp.asarray(toks),
                             last_only=True)
    tl, tcache = ttf.prefill(params, cfg, torch.from_numpy(toks).long(),
                             last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        want = np.asarray(jcache["groups"]["p0"][name])
        got = tcache["groups"]["p0"][name].numpy()
        assert got.shape == want.shape == (cfg.n_layers, 2, 40,
                                           cfg.n_kv_heads * cfg.head_dim)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gqa", [False, True], ids=["mqa", "gqa"])
def test_bulk_prefill_matches_exact_handoff(gqa):
    ref_cfg, cfg, jparams, params = _setup(gqa)
    toks = _tokens(2, 2, 12, cfg.vocab)
    with torch.inference_mode():
        bl, bc = serving.prefill_into_cache(params, cfg, toks, 24,
                                            device="cpu")
        el, ec = serving.prefill_into_cache(params, cfg, toks, 24,
                                            exact=True, device="cpu")
    np.testing.assert_allclose(bl.numpy(), el.numpy(), rtol=0, atol=2e-4)
    fb, fe = params_to_numpy(bc), params_to_numpy(ec)
    assert fb.keys() == fe.keys() == {"groups/p0/k", "groups/p0/v",
                                      "length"}
    for key in fb:
        assert fb[key].shape == fe[key].shape
        np.testing.assert_allclose(fb[key], fe[key], rtol=0, atol=2e-4)
    assert int(bc["length"]) == 12
    # and the reference's bulk handoff lays the cache out the same way
    jl, jc = jax.jit(jserving.make_prefill_fn(ref_cfg, 24))(
        jparams, jnp.asarray(toks))
    np.testing.assert_allclose(bl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(fb[f"groups/p0/{name}"],
                                   np.asarray(jc["groups"]["p0"][name]),
                                   **TOL)


def test_prompt_exceeding_global_cache_is_an_error():
    _, cfg, _, params = _setup(False)
    toks = _tokens(3, 1, 12, cfg.vocab)
    with pytest.raises(ValueError, match="exceeds cache size"):
        serving.prefill_into_cache(params, cfg, toks, max_len=8,
                                   device="cpu")


@pytest.mark.parametrize("gqa", [False, True], ids=["mqa", "gqa"])
def test_decode_step_chain_matches_over_ring_wrap(gqa):
    """B=2, S=24 > max_len=20: the global ring wraps; every step's
    logits agree with the reference's decode_step."""
    ref_cfg, cfg, jparams, params = _setup(gqa, seed=4)
    B, S, max_len = 2, 24, 20
    toks = _tokens(5, B, S, cfg.vocab)
    step = jax.jit(lambda p, t, c: jtf.decode_step(p, ref_cfg, t, c,
                                                   use_pallas=False))
    jcache = jtf.init_cache(ref_cfg, B, max_len=max_len, dtype="float32")
    cache = ttf.init_cache(cfg, B, max_len, device="cpu")
    for t in range(S):
        jl, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        with torch.no_grad():
            tl, cache = ttf.decode_step(
                params, cfg, torch.from_numpy(toks[:, t:t + 1]), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["length"]) == S
    np.testing.assert_allclose(cache["groups"]["p0"]["k"].numpy(),
                               np.asarray(jcache["groups"]["p0"]["k"]),
                               **TOL)


def test_weights_round_trip_bitwise():
    _, _, jparams, params = _setup(True, seed=7)
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    back = params_to_numpy(params)
    assert back.keys() == flat.keys()
    for key, want in flat.items():
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want)


def test_init_params_layout_matches_reference():
    """The port's own random init has the reference's keys and shapes;
    matrices come in the working dtype, norm scales in f32."""
    ref_cfg, cfg = _cfgs(True)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    want = {k: np.asarray(v) for k, v in _flatten(
        jtf.init_params(jax.random.PRNGKey(0), ref_cfg)).items()}
    got = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    from repro_torch.checkpoint.params import _flatten as tflatten

    flat = tflatten(got)
    assert flat.keys() == want.keys()
    for key, t in flat.items():
        assert tuple(t.shape) == want[key].shape, key
        assert t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)


@pytest.mark.parametrize("change", [
    dict(block_pattern=("ssm",)),
    dict(block_pattern=("recurrent", "local")),
    dict(n_enc_layers=2, enc_len=6),
    dict(mrope_sections=(2, 3, 3)),
], ids=["ssm", "rglru", "encdec", "mrope"])
def test_unported_kinds_raise(change):
    """Every kind of the reference is ported and none raises: MoE,
    "ssm" and "recurrent" build their layers (tests/test_torch_moe.py,
    tests/test_torch_ssm_rglru.py, tests/test_torch_archs.py); an
    encoder–decoder config builds ``encoder`` and every layer's
    ``xattn``, an M-RoPE one runs over (3, B, S) positions, and both run
    a finite forward (tests/test_torch_encdec_vlm.py holds them against
    the reference)."""
    _, cfg = _cfgs(False)
    cfg = dataclasses.replace(cfg, **change)
    params = ttf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(3, 2, 8, cfg.vocab)).long()
    if "block_pattern" in change:
        leaf = {"ssm": "ssm", "recurrent": "rglru"}[change["block_pattern"][0]]
        assert leaf in params["groups"]["p0"]
        return
    kw = {}
    if cfg.is_encdec:
        assert "xattn" in params["groups"]["p0"]
        assert set(params["encoder"]) == {"enc_norm", "groups"}
        kw["enc_frames"] = torch.randn(2, cfg.enc_len, cfg.d_model)
    else:
        kw["positions"] = torch.stack([torch.zeros(2, 8, dtype=torch.long),
                                       torch.arange(8).expand(2, 8),
                                       torch.arange(8).flip(0).expand(2, 8)])
    logits, _ = ttf.forward(params, cfg, toks, **kw)
    assert logits.shape == (2, 8, cfg.vocab)
    assert torch.isfinite(logits).all()
    moe = dataclasses.replace(_cfgs(False)[1], n_experts=4, top_k=2)
    assert "moe" in ttf.init_params(moe, device="cpu")["groups"]["p0"]


def test_variant_layers_match_reference():
    """The ported code paths llama3 does not take: local (sliding
    window, ring-trimmed cache) + global layers with a remainder layer,
    logit softcap, layer norm, gelu MLP, tied embeddings."""
    changes = dict(n_layers=3, block_pattern=("local", "global"), window=8,
                   logit_softcap=30.0, norm="layer", mlp="gelu",
                   tie_embeddings=True, n_heads=8, n_kv_heads=2)
    ref_cfg, cfg = _cfgs(False)
    ref_cfg = dataclasses.replace(ref_cfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    jparams = jtf.init_params(jax.random.PRNGKey(9), ref_cfg)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(jparams).items()}, "cpu")
    toks = _tokens(10, 2, 12, cfg.vocab)
    jlogits, _ = jtf.forward(jparams, ref_cfg, jnp.asarray(toks))
    logits, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # bulk handoff (local ring trimmed to the window) == exact, and the
    # decode chain continues like the reference's
    max_len = 20
    with torch.inference_mode():
        bl, bc = serving.prefill_into_cache(params, cfg, toks, max_len,
                                            device="cpu")
        el, ec = serving.prefill_into_cache(params, cfg, toks, max_len,
                                            exact=True, device="cpu")
        fb, fe = params_to_numpy(bc), params_to_numpy(ec)
        assert fb["groups/p0/k"].shape[-2] == 8  # local ring = window
        for key in fb:
            np.testing.assert_allclose(fb[key], fe[key], rtol=0, atol=2e-4)
        jl, jc = jax.jit(jserving.make_prefill_fn(ref_cfg, max_len))(
            jparams, jnp.asarray(toks))
        np.testing.assert_allclose(bl.numpy(), np.asarray(jl), **TOL)
        step = jax.jit(lambda p, t, c: jtf.decode_step(p, ref_cfg, t, c,
                                                       use_pallas=False))
        nxt = _tokens(11, 2, 6, cfg.vocab)
        for t in range(6):
            jl, jc = step(jparams, jnp.asarray(nxt[:, t:t + 1]), jc)
            tl, bc = ttf.decode_step(params, cfg,
                                     torch.from_numpy(nxt[:, t:t + 1]), bc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
