"""Port vs reference: the training pieces, at smoke width in float32.

  * flash attention: forward, the per-row log-sum-exp and the gradients
    of ``models.attention.FlashAttention`` against ``jax.vjp`` of
    ``repro.models.attention.flash_attention`` (GQA, window, softcap);
  * ``loss_and_metrics`` and the gradient of every param leaf for the
    llama3-8b smoke config (with the coded weights and fixed denom);
  * one update of each optimizer, and ``make_train_step`` with and
    without microbatching, against the reference's.

The reference initializes the weights; the port loads them by their
flat keys.  Tolerances: 2e-5 on attention outputs, 5e-5 on its
gradients (those of ``tests/test_flash_attention.py``), 1e-5 relative
on losses and params (adamw params: 1e-2·lr), 1e-4 of each leaf's max
on gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten, _unflatten
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import _tree
from repro_torch.checkpoint.params import _flatten as _tflatten
from repro_torch.checkpoint.params import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.optim import make_optimizer


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("B,S,Kv,G,causal,window,softcap", [
    (1, 32, 1, 1, True, 0, 0.0),
    (2, 64, 2, 2, True, 16, 0.0),
    (1, 64, 2, 4, True, 0, 20.0),
    (2, 32, 1, 2, False, 0, 20.0),
    (1, 48, 2, 2, True, 8, 30.0),
])
def test_flash_forward_lse_and_grads_match_jax_vjp(B, S, Kv, G, causal,
                                                   window, softcap):
    Dh = 8
    q, k, v = _np(1, B, S, Kv * G, Dh), _np(2, B, S, Kv, Dh), _np(3, B, S,
                                                                  Kv, Dh)
    do = _np(4, B, S, Kv * G, Dh)
    chunk = 16

    def jflash(q, k, v):
        return jattn.flash_attention(q, k, v, causal, window, softcap,
                                     chunk, 0)

    jout, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, window,
                                    softcap, chunk, 0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal, window, softcap, chunk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    _, lse = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, softcap=softcap,
                                 return_lse=True)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, S, Kv * G),
                               rtol=2e-5, atol=2e-5)
    out.backward(torch.from_numpy(do))
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=5e-5, atol=5e-5)


def _model(gqa=False, seed=0):
    ref = dataclasses.replace(ref_smoke("llama3-8b"), dtype="float32")
    mine = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    if gqa:
        ref = dataclasses.replace(ref, n_heads=8, n_kv_heads=2)
        mine = dataclasses.replace(mine, n_heads=8, n_kv_heads=2)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), ref)
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return ref, mine, jparams, flat


def _batch(cfg, seed, B=4, S=16, denom=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "weights": rng.random((B, S)).astype(np.float32)}
    if denom:
        b["denom"] = np.float32(B * S * 2)
    return b


def _torch_batch(b):
    return {k: (torch.from_numpy(np.asarray(v)).long()
                if k in ("tokens", "targets") else torch.as_tensor(v))
            for k, v in b.items()}


def _leaf_params(flat):
    params = params_from_numpy(flat, "cpu", dtype=torch.float32)
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    return params


def _by_key(tree):
    if any(isinstance(x, torch.Tensor) for x in _tree.leaves(tree)):
        return {k: v.detach().numpy() for k, v in _tflatten(tree).items()}
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("gqa", [False, True], ids=["mqa", "gqa"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_leaf_gradients_match(gqa, remat):
    ref, cfg, jparams, flat = _model(gqa)
    cfg = dataclasses.replace(cfg, remat=remat)
    b = _batch(cfg, 1)
    (jtotal, jm), jgrads = jax.value_and_grad(
        jtf.loss_and_metrics, has_aux=True)(
        jparams, ref, {k: jnp.asarray(v) for k, v in b.items()})
    params = _leaf_params(flat)
    total, m = ttf.loss_and_metrics(params, cfg, _torch_batch(b))
    grads = torch.autograd.grad(total, _tree.leaves(params))
    assert float(m["loss"].detach()) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
    assert float(m["weight_sum"]) == pytest.approx(float(jm["weight_sum"]),
                                                   rel=1e-6)
    mine = _by_key(_tree.unflatten_like(params, list(grads)))
    want = _by_key(jgrads)
    assert mine.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(mine[key], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adafactor"])
def test_one_optimizer_update_matches(name):
    _, _, jparams, flat = _model()
    rng = np.random.default_rng(5)
    gflat = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flat.items()}
    ref_opt, opt = ref_make_optimizer(name), make_optimizer(name)
    jgrads = _unflatten({k: jnp.asarray(v) for k, v in gflat.items()})
    params = params_from_numpy(flat, "cpu", dtype=torch.float32)
    grads = params_from_numpy(gflat, "cpu", dtype=torch.float32)
    jstate, state = ref_opt.init(jparams), opt.init(params)
    lr = torch.tensor(0.01, dtype=torch.float32)
    for it in range(2):  # the second update reads the first's state
        jup, jstate = ref_opt.update(jgrads, jstate, jparams,
                                     jnp.float32(0.01), 0.1)
        # apply_, what training runs, on copies: it must add exactly the
        # update to each param and leave exactly the new state
        applied, applied_state = _tree.map(torch.clone, (params, state))
        applied_state = opt.apply_(_tree.leaves(grads), applied_state,
                                   applied, lr, 0.1)
        up, state = opt.update(grads, state, params, lr, 0.1)
        mine, want = _by_key(up), _by_key(jup)
        for key, w in want.items():
            np.testing.assert_allclose(mine[key], w, rtol=1e-5, atol=1e-8,
                                       err_msg=f"{name} update {it} {key}")
        for a, p, u in zip(*map(_tree.leaves, (applied, params, up))):
            assert torch.equal(a, p + u)
        for a, s in zip(*map(_tree.leaves, (applied_state, state))):
            assert torch.equal(a, s)
    ms, ws = _by_key(state), _by_key(jstate)
    assert ms.keys() == ws.keys()
    for key, w in ws.items():
        np.testing.assert_allclose(ms[key], w, rtol=1e-5, atol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("opt,denom,microbatch", [
    ("sgd", True, 0), ("sgd", True, 2), ("sgd", False, 0), ("sgd", False, 2),
    ("adamw", True, 0), ("adamw", False, 2)])
def test_make_train_step_matches(opt, denom, microbatch):
    ref, cfg, jparams, flat = _model()
    b = _batch(cfg, 3, denom=denom)
    kw = dict(optimizer=opt, lr=0.05, total_steps=10, warmup_steps=2,
              grad_clip=1.0, microbatch=microbatch)
    rstep = jax.jit(ref_steps.make_train_step(
        ref, RefTrainConfig(**kw), optimizer=ref_make_optimizer(opt)))
    ropt = ref_make_optimizer(opt)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jp, js = jparams, ropt.init(jparams)
    tstep = steps.make_train_step(cfg, TrainConfig(**kw),
                                  optimizer=make_optimizer(opt))
    params = _leaf_params(flat)
    state = tstep.optimizer.init(params)
    for step in range(2):
        jp, js, jm = rstep(jp, js, jb, jnp.asarray(step + 1))
        params, state, m = tstep(params, state, _torch_batch(b), step + 1)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert float(m["lr"]) == float(jm["lr"])
    # adamw divides by √v̂: an element whose gradient is at f32 rounding
    # level moves by up to lr·sign in either package, so its bound is a
    # share of lr (the reference's own tests compare adamw runs loosely
    # for the same reason)
    atol = 1e-6 if opt == "sgd" else 1e-2 * kw["lr"]
    mine, want = _by_key(params), _by_key(jp)
    for key, w in want.items():
        np.testing.assert_allclose(mine[key], w, rtol=1e-5, atol=atol,
                                   err_msg=key)


def test_microbatched_step_sums_on_the_denom_path():
    _, cfg, _, flat = _model()
    b = _torch_batch(_batch(cfg, 4))
    kw = dict(optimizer="sgd", lr=0.05, total_steps=10, warmup_steps=1,
              grad_clip=0.0)
    losses = []
    for mb in (0, 1, 2):
        step = steps.make_train_step(cfg, TrainConfig(microbatch=mb, **kw))
        params = _leaf_params(flat)
        _, _, m = step(params, step.optimizer.init(params), b, 0)
        losses.append(float(m["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    assert losses[2] == pytest.approx(losses[0], rel=1e-6)
