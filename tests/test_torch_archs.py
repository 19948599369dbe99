"""Port vs reference: the seven configs ported beside llama3-8b.

granite-8b, starcoder2-3b and gemma3-27b (dense: global/local layers,
the ring-trimmed window, gelu + layer norm, tied embeddings),
granite-moe-3b-a800m and llama4-maverick-400b-a17b (MoE; maverick
interleaves dense and MoE layers and has a shared expert), mamba2-370m
(SSD layers only) and recurrentgemma-2b (two RG-LRU layers to one local
attention layer, two RG-LRU ``rest`` layers).  Their smoke configs run
in float32 on the CPU from the reference's seeded weights, carried by
flat key (maverick's bfloat16 ``param_dtype`` is set to float32 on both
sides for that).  Tolerances as in ``tests/test_torch_transformer.py``:
1e-4 on logits, aux and the loss; gradients 1e-4 of each leaf's largest
value.  The recurrent archs' decode chain against the port's own
full-sequence forward: 1e-4 as well (float32; the reference holds its
bf16 chain to 5e-2, ``tests/test_decode_consistency.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import transformer as jtf
from repro_torch import _tree
from repro_torch.api import serving
from repro_torch.checkpoint.params import _flatten as tflatten
from repro_torch.checkpoint.params import params_from_numpy
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import transformer as ttf
from torch_reference import few_threads  # noqa: F401 (autouse)

ARCHS = ["granite-8b", "starcoder2-3b", "gemma3-27b", "granite-moe-3b-a800m",
         "llama4-maverick-400b-a17b", "mamba2-370m", "recurrentgemma-2b"]
MOE = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
RECURRENT = ["mamba2-370m", "recurrentgemma-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(arch, **changes):
    changes = {**F32, **changes}
    return (dataclasses.replace(ref_smoke(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _setup(arch, seed=0, **changes):
    ref_cfg, cfg = _cfgs(arch, **changes)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return ref_cfg, cfg, jparams, params_from_numpy(flat, "cpu")


def _tokens(seed, B, S, V):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_counts() == theirs.param_counts()
    if arch == "llama4-maverick-400b-a17b":
        cfg = get_config(arch)
        assert (cfg.moe_pattern, cfg.d_ff_dense, cfg.n_shared_experts,
                cfg.param_dtype) == ((False, True), 16384, 1, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_reference(arch):
    """The port's own init has the reference's keys and shapes: ``moe``
    where ``moe_at(k)``, experts of width d_ff, dense layers of width
    d_ff_dense or d_ff; matrices in the working dtype."""
    cfg = get_smoke_config(arch)
    want = {k: np.asarray(v).shape for k, v in _flatten(
        jtf.init_params(jax.random.PRNGKey(0), ref_smoke(arch))).items()}
    got = tflatten(ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"))
    assert {k: tuple(t.shape) for k, t in got.items()} == want
    for key, t in got.items():
        assert t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)
    assert any("/moe/" in k for k in got) == (arch in MOE)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    ref_cfg, cfg, jparams, params = _setup(arch, seed=1)
    toks = _tokens(2, 2, 40, cfg.vocab)
    jlogits, jaux = jtf.forward(jparams, ref_cfg, jnp.asarray(toks))
    logits, aux = ttf.forward(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (arch in MOE)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_gradients_match(arch, remat):
    _check_loss_and_gradients(arch, remat)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_loss_and_gradients_match(arch, remat):
    """The SSD's chunked form (24 tokens: three chunks of 8 for mamba2)
    and the doubling scan differentiated by autograd against JAX."""
    _check_loss_and_gradients(arch, remat)


def _check_loss_and_gradients(arch, remat):
    ref_cfg, cfg, jparams, params = _setup(arch, seed=3, remat=remat)
    rng = np.random.default_rng(4)
    batch = {"tokens": _tokens(5, 2, 24, cfg.vocab),
             "targets": _tokens(6, 2, 24, cfg.vocab),
             "weights": rng.random((2, 24)).astype(np.float32)}

    def jtotal(p):
        return jtf.loss_and_metrics(
            p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})

    (jt, jm), jg = jax.value_and_grad(jtotal, has_aux=True)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    leaves = _tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, m = ttf.loss_and_metrics(params, cfg, tb)
    grads = torch.autograd.grad(total, leaves)
    total, m = total.detach(), {k: v.detach() for k, v in m.items()}
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), **TOL)
    np.testing.assert_allclose(float(total), float(jt), **TOL)
    want = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    got = tflatten(_tree.unflatten_like(params, list(grads)))
    assert got.keys() == want.keys()
    for key, g in got.items():
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=key)


@pytest.mark.parametrize("exact", [False, True], ids=["bulk", "exact"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_serve(arch, exact):
    """Greedy tokens of the same handoff as the reference's: for MoE the
    bulk prefill (capacity over B·S tokens) and the token-by-token
    handoff (over B) legitimately differ.  The 20-token prompt passes
    gemma3's 16-token window, so its local rings wrap."""
    ref_cfg, cfg, jparams, params = _setup(arch, seed=7)
    prompt = _tokens(8, 2, 20, cfg.vocab)
    want = jserving.generate(jparams, ref_cfg, prompt, 6,
                             exact_handoff=exact)
    got = serving.generate(params, cfg, prompt, 6, exact_handoff=exact,
                           device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_chain_matches_forward(arch):
    """The port's counterpart of ``tests/test_decode_consistency.py``:
    token-by-token decode (recurrent states, and recurrentgemma's local
    ring wrapped: 40 tokens over a 16-token window) equals the
    full-sequence forward at every position, and the chain's greedy
    tokens equal the forward's."""
    _, cfg, _, params = _setup(arch, seed=9)
    toks = torch.from_numpy(_tokens(10, 2, 40, cfg.vocab)).long()
    full, _ = ttf.forward(params, cfg, toks)
    cache = ttf.init_cache(cfg, 2, max_len=40, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = ttf.decode_step(params, cfg, toks[:, t:t + 1], cache)
        outs.append(logits)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
    assert int(cache["length"]) == 40


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_states_stay_float32_in_a_bf16_model(arch):
    """A bf16 model's decode cache: attention rings in bf16 (the decode
    kernel reads q and the cache in one dtype), the SSD and RG-LRU
    states in float32 as the reference makes them, also after steps."""
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    cache = ttf.init_cache(cfg, 2, max_len=8, device="cpu")
    for t in range(3):
        logits, cache = ttf.decode_step(
            params, cfg, torch.full((2, 1), t, dtype=torch.long), cache)
        assert torch.isfinite(logits).all()
    for key, t in tflatten(cache).items():
        if key == "length":
            continue
        kind = "attn" if key.split("/")[-1] in ("k", "v") else "state"
        want = torch.bfloat16 if kind == "attn" else torch.float32
        assert t.dtype == want, key
