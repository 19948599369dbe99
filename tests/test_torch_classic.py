"""Port vs reference: the paper's logistic-regression and CNN models.

The reference's seeded weights (``repro.models.classic.init_*``) are
carried into the port by ``checkpoint.params.classic_params_from_
reference`` (convolutions HWIO → OIHW), and both packages run the same
numpy batch.  Tolerances (float32, only the summation order differs):
logits within 1e-5·max|logit|; gradients (``grad_fn``, and the per-part
gradients of ``part_grads`` for K = 4 parts, the reference's
``jax.vmap``) within 1e-4 of each leaf's max |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import classic as ref
from repro_torch import _tree
from repro_torch.checkpoint.params import (
    _flatten,
    classic_params_from_reference,
)
from repro_torch.models import classic

MODELS = {  # name → (reference init, reference apply, port apply, x shape)
    "logreg": (ref.init_logreg, ref.apply_logreg, classic.apply_logreg,
               (784,)),
    "cnn": (ref.init_cnn, ref.apply_cnn, classic.apply_cnn, (32, 32, 3)),
}


def _setup(model, batch=6, seed=0):
    init, ref_apply, apply, shape = MODELS[model]
    rp = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch,) + shape).astype(np.float32)
    y = rng.integers(0, 10, batch)
    return rp, ref_apply, classic_params_from_reference(rp, "cpu"), apply, \
        x, y


def _ref_numpy(tree):
    """A reference tree in the port's layout, flat keys → numpy."""
    return {k: v.numpy() for k, v in _flatten(
        classic_params_from_reference(jax.tree.map(np.asarray, tree),
                                      "cpu")).items()}


def _close_by_leaf(got_tree, want_tree, share):
    want = _ref_numpy(want_tree)
    got = {k: v.detach().numpy() for k, v in _flatten(got_tree).items()}
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= share * scale, k


@pytest.mark.parametrize("model", MODELS)
def test_init_layout_matches_reference(model):
    init = {"logreg": classic.init_logreg, "cnn": classic.init_cnn}[model]
    mine = init(0)
    want = _ref_numpy(MODELS[model][0](jax.random.PRNGKey(0)))
    got = _flatten(mine)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
        # same scale as the reference's draw (He-normal / 0.01), zero biases
        if k.endswith("b"):
            assert not v.any()
        else:
            assert abs(v.std().item() / want[k].std() - 1) < 0.25, k
    again, other = init(0), init(1)
    for k, v in _flatten(again).items():
        assert torch.equal(v, got[k])
    assert any(not torch.equal(v, got[k]) for k, v in _flatten(other).items()
               if not k.endswith("b"))


@pytest.mark.parametrize("model", MODELS)
def test_logits_match_reference(model):
    rp, ref_apply, params, apply, x, _ = _setup(model)
    want = np.asarray(ref_apply(rp, jnp.asarray(x)))
    got = apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("model", MODELS)
def test_loss_and_accuracy_match_reference(model):
    rp, ref_apply, params, apply, x, y = _setup(model, batch=16)
    logits = np.asarray(ref_apply(rp, jnp.asarray(x)))
    mine = apply(params, torch.from_numpy(x))
    want_loss = float(ref.xent_loss(jnp.asarray(logits), jnp.asarray(y)))
    got_loss = classic.xent_loss(mine, torch.from_numpy(y)).item()
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    assert classic.accuracy(mine, torch.from_numpy(y)).item() == \
        float(ref.accuracy(jnp.asarray(logits), jnp.asarray(y)))


@pytest.mark.parametrize("model", MODELS)
def test_grad_fn_matches_reference(model):
    rp, ref_apply, params, apply, x, y = _setup(model, batch=8)
    want = ref.grad_fn(ref_apply, rp, jnp.asarray(x), jnp.asarray(y))
    got = classic.grad_fn(apply, params, torch.from_numpy(x),
                          torch.from_numpy(y))
    _close_by_leaf(got, want, 1e-4)


@pytest.mark.parametrize("model", MODELS)
def test_part_grads_match_reference_vmap(model):
    K, b = 4, 3
    rp, ref_apply, params, apply, x, y = _setup(model, batch=K * b)
    xs, ys = x.reshape((K, b) + x.shape[1:]), y.reshape(K, b)
    want = jax.vmap(lambda xk, yk: ref.grad_fn(ref_apply, rp, xk, yk))(
        jnp.asarray(xs), jnp.asarray(ys))
    got = classic.part_grads(apply, params, torch.from_numpy(xs),
                             torch.from_numpy(ys))
    for k in range(K):
        _close_by_leaf(_tree.map(lambda g: g[k], got),
                       jax.tree.map(lambda g: g[k], want), 1e-4)


def _apply_cnn_nchw_flatten(params, x):
    """The port's CNN with the trap sprung: the last activation flattened
    in NCHW order, so ``fc0``'s rows are read in the wrong order."""
    h = x.permute(0, 3, 1, 2)
    for i in range(6):
        p = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, p["w"], p["b"], padding=1))
        if i % 2 == 1:
            h = F.max_pool2d(h, 2)
    h = h.reshape(h.shape[0], -1)
    for i in range(3):
        h = h @ params[f"fc{i}"]["w"] + params[f"fc{i}"]["b"]
        if i < 2:
            h = F.relu(h)
    return h


def test_cnn_flatten_order_is_the_references():
    """fc0 must see the (H, W, C) flattening: the port's logits meet the
    1e-5 bound, and the same weights flattened NCHW miss it by far."""
    rp, ref_apply, params, apply, x, _ = _setup("cnn")
    want = np.asarray(ref_apply(rp, jnp.asarray(x)))
    scale = np.abs(want).max()
    got = apply(params, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * scale
    wrong = _apply_cnn_nchw_flatten(params, torch.from_numpy(x)).numpy()
    assert np.abs(wrong - want).max() > 1e-2 * scale
