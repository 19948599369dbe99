"""The port's Mamba-2 SSD and RG-LRU blocks, on the CPU, in float32.

The cases of ``tests/test_ssm_rglru.py`` on the port's functions
(chunked SSD == its per-token recurrence, with and without an initial
state; the SSM decode chain == the full-sequence block; the RG-LRU scan
== its step chain; the decay keeps a 512-step state bounded), then each
of the port's functions against the reference's on the same numpy
inputs: ``ssd_chunked``, ``ssm_forward``, ``ssm_decode_step``,
``rglru_scan`` (S = 512: nine passes of the doubling scan),
``rglru_block_forward``/``rglru_block_step`` and the deterministic init
leaves.

Tolerances: 1e-4, the reference's own for the chunked SSD against its
recurrence (float32; the two forms and the two packages sum in other
orders); 2e-4 for the decode chains against the full-sequence blocks,
the reference's for the same check; the init leaves 1e-4 relative:
``linspace`` rounds a value an ulp apart in the two packages, and
``lam = logit(a)`` scales that by 1 / (a (1 - a)) ≈ 1000 near a = 0.999.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import rglru as jR
from repro.models import ssm as jS
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from torch_reference import few_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
CHAIN_TOL = dict(rtol=2e-4, atol=2e-4)


def _ssd_inputs(seed, B, Sq, nh, hd, N, h0=False):
    """(xbar, logdA, Bc, Cc[, h0]) as numpy float32, logdA < 0."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, Sq, nh, hd)) * 0.5,
           -np.log1p(np.exp(rng.normal(size=(B, Sq, nh)))),
           rng.normal(size=(B, Sq, N)) * 0.5,
           rng.normal(size=(B, Sq, N)) * 0.5]
    if h0:
        out.append(rng.normal(size=(B, nh, hd, N)))
    return [a.astype(np.float32) for a in out]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _ssm_cfgs():
    kw = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=0,
              n_kv_heads=0, head_dim=1, d_ff=0, vocab=8,
              block_pattern=("ssm",), d_state=8, expand=2, ssm_head_dim=8,
              ssm_chunk=4)
    return RefConfig(**kw), ModelConfig(**kw)


def _rglru_cfgs():
    kw = dict(name="t", family="hybrid", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=1, d_ff=32, vocab=8, block_pattern=("recurrent",),
              lru_width=16)
    return RefConfig(**kw), ModelConfig(**kw)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _ssm_params(cfg, seed=0):
    """The reference's init_ssm leaves (numpy) and the same as tensors."""
    p = _np_tree(jS.init_ssm(jax.random.PRNGKey(seed), cfg.d_model,
                             cfg.expand, cfg.d_state, cfg.d_conv,
                             cfg.ssm_head_dim, jnp.float32))
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _rglru_params(cfg, seed=0):
    p = _np_tree(jR.init_rglru_block(jax.random.PRNGKey(seed), cfg.d_model,
                                     cfg.lru_width, cfg.d_conv, jnp.float32))
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(
        np.float32)


# ----------------------------------------------------------------------
# the reference's own cases, on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("seed,B,Sq,chunk", [(0, 1, 8, 2), (3, 2, 16, 4),
                                            (11, 2, 16, 8), (29, 1, 16, 16)])
def test_ssd_chunked_equals_recurrence(seed, B, Sq, chunk, with_h0):
    xbar, logdA, Bc, Cc, *h0 = _t(_ssd_inputs(seed, B, Sq, 2, 4, 4, with_h0))
    h0 = h0[0] if h0 else None
    y_c, h_c = S.ssd_chunked(xbar, logdA, Bc, Cc, chunk=chunk, h0=h0)
    y_r, h_r = S.ssd_reference(xbar, logdA, Bc, Cc, h0=h0)
    torch.testing.assert_close(y_c, y_r, **TOL)
    torch.testing.assert_close(h_c, h_r, **TOL)


def test_ssd_chunked_rejects_a_ragged_sequence():
    xbar, logdA, Bc, Cc = _t(_ssd_inputs(0, 1, 12, 2, 4, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.ssd_chunked(xbar, logdA, Bc, Cc, chunk=8)


def test_ssd_gradients_finite():
    xbar, logdA, Bc, Cc = _t(_ssd_inputs(3, 1, 16, 2, 4, 4))
    xbar.requires_grad_(True)
    y, _ = S.ssd_chunked(xbar, logdA, Bc, Cc, chunk=4)
    (g,) = torch.autograd.grad((y ** 2).sum(), [xbar])
    assert torch.isfinite(g).all()


def test_ssd_gradients_finite_over_a_long_chunk():
    """mamba2-370m's 256-token chunk with decays summing past e^88: the
    masked segsum keeps the gradients finite where the reference's
    (exp before the mask) overflow to NaN (ROADMAP §3)."""
    xbar, logdA, Bc, Cc = _t(_ssd_inputs(4, 1, 256, 2, 4, 4))
    logdA = (logdA * 4).requires_grad_(True)  # Σ |logdA| over 256 ≫ 88
    assert logdA.detach().abs().sum(1).min() > 88
    y, h = S.ssd_chunked(xbar, logdA, Bc, Cc, chunk=256)
    (g,) = torch.autograd.grad((y ** 2).sum() + h.sum(), [logdA])
    assert torch.isfinite(y).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("block", ["ssm", "rglru"])
def test_decode_chain_matches_forward(block):
    """Tokens fed one by one through the decode step reproduce the
    full-sequence block at every position."""
    if block == "ssm":
        _, cfg = _ssm_cfgs()
        _, p = _ssm_params(cfg)
        full_fn, step_fn = S.ssm_forward, S.ssm_decode_step
        cache, T = S.ssm_init_cache(cfg, 2), 8
    else:
        _, cfg = _rglru_cfgs()
        _, p = _rglru_params(cfg)
        full_fn, step_fn = R.rglru_block_forward, R.rglru_block_step
        cache, T = R.rglru_init_cache(cfg, 2), 10
    x = torch.from_numpy(_x(1, 2, T, cfg.d_model))
    full = full_fn(p, x, cfg)
    outs = []
    for t in range(T):
        o, cache = step_fn(p, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, **CHAIN_TOL)
    assert all(v.dtype == torch.float32 for v in cache.values())


def test_rglru_scan_matches_step_chain():
    _, cfg = _rglru_cfgs()
    _, p = _rglru_params(cfg)
    y = torch.from_numpy(_x(2, 2, 37, cfg.lru_width))
    h0 = torch.from_numpy(_x(3, 2, cfg.lru_width))
    hs, last = R.rglru_scan(p, y, h0=h0)
    h, steps = h0, []
    for t in range(y.shape[1]):
        o, h = R.rglru_step(p, y[:, t:t + 1], h)
        steps.append(o)
    torch.testing.assert_close(hs, torch.cat(steps, 1), **TOL)
    torch.testing.assert_close(last, h, **TOL)


def test_rglru_decay_stability():
    """|a_t| < 1 everywhere ⇒ bounded hidden states on long sequences."""
    p = R.init_rglru_block(8, 8, 4, torch.Generator().manual_seed(0))
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 512, 8)).astype(np.float32))
    h, _ = R.rglru_scan(p, y)
    assert torch.isfinite(h).all()
    assert h.abs().max().item() < 100.0


# ----------------------------------------------------------------------
# port against reference, same numpy inputs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("Sq,chunk", [(16, 4), (64, 16)])
def test_ssd_chunked_matches_reference(Sq, chunk, with_h0):
    arrays = _ssd_inputs(5, 2, Sq, 3, 8, 6, with_h0)
    kw_t = dict(h0=torch.from_numpy(arrays[4])) if with_h0 else {}
    kw_j = dict(h0=jnp.asarray(arrays[4])) if with_h0 else {}
    y, h = S.ssd_chunked(*_t(arrays[:4]), chunk=chunk, **kw_t)
    jy, jh = jS.ssd_chunked(*_j(arrays[:4]), chunk=chunk, **kw_j)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("Sq", [4, 12, 16])
def test_ssm_forward_matches_reference(Sq):
    """chunk = min(ssm_chunk, S): one chunk at S = 4, three at S = 12."""
    jcfg, cfg = _ssm_cfgs()
    jp, p = _ssm_params(jcfg, seed=1)
    x = _x(4, 2, Sq, cfg.d_model)
    got = S.ssm_forward(p, torch.from_numpy(x), cfg)
    want = jS.ssm_forward({k: jnp.asarray(v) for k, v in jp.items()},
                          jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block", ["ssm", "rglru"])
def test_decode_step_matches_reference(block):
    """Six decode steps from a random (nonzero) state: outputs and the
    carried h and conv states, step by step."""
    rng = np.random.default_rng(6)
    if block == "ssm":
        jcfg, cfg = _ssm_cfgs()
        jp, p = _ssm_params(jcfg, seed=2)
        cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in
                 S.ssm_init_cache(cfg, 2).items()}
        step, jstep = S.ssm_decode_step, jS.ssm_decode_step
    else:
        jcfg, cfg = _rglru_cfgs()
        jp, p = _rglru_params(jcfg, seed=2)
        cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in
                 R.rglru_init_cache(cfg, 2).items()}
        step, jstep = R.rglru_block_step, jR.rglru_block_step
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    for t in range(6):
        x = _x(10 + t, 2, 1, cfg.d_model)
        out, tc = step(p, torch.from_numpy(x), tc, cfg)
        jout, jc = jstep(jp, jnp.asarray(x), jc, jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("Sq", [1, 7, 512])
def test_rglru_scan_matches_reference(Sq):
    """The doubling scan against ``lax.associative_scan``; S = 512 runs
    nine passes, S = 7 a last pass without the composed decay."""
    jcfg, _ = _rglru_cfgs()
    jp, p = _rglru_params(jcfg, seed=3)
    y = _x(7, 2, Sq, jcfg.lru_width)
    h0 = _x(8, 2, jcfg.lru_width)
    for kw_t, kw_j in (({}, {}), (dict(h0=torch.from_numpy(h0)),
                                  dict(h0=jnp.asarray(h0)))):
        h, last = R.rglru_scan(p, torch.from_numpy(y), **kw_t)
        jh, jlast = jR.rglru_scan({k: jnp.asarray(v) for k, v in jp.items()},
                                  jnp.asarray(y), **kw_j)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)


def test_rglru_block_forward_matches_reference():
    jcfg, cfg = _rglru_cfgs()
    jp, p = _rglru_params(jcfg, seed=4)
    x = _x(9, 2, 33, cfg.d_model)
    got = R.rglru_block_forward(p, torch.from_numpy(x), cfg)
    want = jR.rglru_block_forward({k: jnp.asarray(v) for k, v in jp.items()},
                                  jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["rest", "stacked"])
@pytest.mark.parametrize("block", ["ssm", "rglru"])
def test_init_leaves_match_reference(block, lead):
    """Keys and shapes of every leaf; the deterministic vectors' values
    (``A_log``, ``D``, ``dt_bias``, zero biases; ``lam``, ``b_a``,
    ``b_x``); the random matrices N(0, 0.02²).  A stacked layer's
    vectors come in the working dtype (bf16), a rest layer's in float32."""
    d, r = 64, 96
    if block == "ssm":
        want = _np_tree(jS.init_ssm(jax.random.PRNGKey(0), d, 2, 16, 4, 16,
                                    jnp.float32))
        got = S.init_ssm(d, 2, 16, 4, 16, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, lead=lead)
        vectors = ("A_log", "D", "dt_bias", "conv_x_b", "conv_bc_b")
    else:
        want = _np_tree(jR.init_rglru_block(jax.random.PRNGKey(0), d, r, 4,
                                            jnp.float32))
        got = R.init_rglru_block(d, r, 4, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16, lead=lead)
        vectors = ("lam", "b_a", "b_x", "conv_b")
    assert got.keys() == want.keys()
    for k, w in want.items():
        t = got[k]
        assert tuple(t.shape) == lead + w.shape, k
        assert t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)
        if k in vectors:
            for row in t.reshape(-1, *w.shape):
                rtol = 1e-2 if lead else 1e-4  # bf16: 8 bits of mantissa
                np.testing.assert_allclose(row.float().numpy(), w, rtol=rtol,
                                           atol=0, err_msg=k)
        else:
            assert abs(t.float().std().item() - 0.02) < 0.004, k
