"""The paper's own evaluation models (§V-A), in PyTorch:

  * logistic regression for MNIST (784 → 10),
  * a CNN with 6 convolution layers and 3 fully-connected layers for
    CIFAR-10 (32×32×3 → 10).

Plain functions on a dict of tensors (``init_*`` / ``apply_*`` pairs and
a softmax-CE loss), so that ``torch.func.grad`` and ``vmap`` take them;
used by the simulator (``repro_torch.sim``).  Images come in NHWC, as
the data pipeline makes them and the reference's ``apply_cnn`` takes
them.  Convolution weights are OIHW (the reference's are HWIO;
``checkpoint.params.classic_params_from_reference`` carries them over);
the last activation is flattened in (H, W, C) order, the reference's,
so ``fc0``'s rows mean the same in both packages.  The initializers draw
from a ``torch.Generator`` seeded by ``seed`` on ``device``; they do not
reproduce ``jax.random``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, object]

#: the CNN's channel widths: input, then the six convolutions'
CNN_CHANNELS = (3, 32, 32, 64, 64, 128, 128)
#: the fully-connected widths: 4×4×128 after three 2×2 pools, then 256,
#: 128 and the classes
CNN_FC_DIMS = (2048, 256, 128, 10)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def init_logreg(seed: int = 0, n_features: int = 784, n_classes: int = 10,
                device="cpu") -> Params:
    gen = _generator(seed, device)
    return {
        "w": torch.randn(n_features, n_classes, generator=gen,
                         device=device) * 0.01,
        "b": torch.zeros(n_classes, device=device),
    }


def apply_logreg(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


def init_cnn(seed: int = 0, in_ch: int = 3, n_classes: int = 10,
             device="cpu") -> Params:
    """6 conv layers (3×3, OIHW) + 3 FC layers (paper's CIFAR-10 model),
    He-normal weights and zero biases as in the reference."""
    gen = _generator(seed, device)
    chans = (in_ch,) + CNN_CHANNELS[1:]
    params: Params = {}
    for i in range(6):
        fan_in = chans[i] * 9
        params[f"conv{i}"] = {
            "w": torch.randn(chans[i + 1], chans[i], 3, 3, generator=gen,
                             device=device) * math.sqrt(2.0 / fan_in),
            "b": torch.zeros(chans[i + 1], device=device),
        }
    dims = CNN_FC_DIMS[:3] + (n_classes,)
    for i in range(3):
        params[f"fc{i}"] = {
            "w": torch.randn(dims[i], dims[i + 1], generator=gen,
                             device=device) * math.sqrt(2.0 / dims[i]),
            "b": torch.zeros(dims[i + 1], device=device),
        }
    return params


def apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) NHWC → logits (B, 10).

    The NHWC input is read as an NCHW view (channels-last in memory);
    "SAME" 3×3 convolutions are ``padding=1``; the reference's
    ``reduce_window`` max (−inf init, "VALID") is ``max_pool2d(2)``.
    """
    h = x.permute(0, 3, 1, 2)
    for i in range(6):
        p = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, p["w"], p["b"], padding=1))
        if i % 2 == 1:
            h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (H, W, C) order
    for i in range(3):
        h = h @ params[f"fc{i}"]["w"] + params[f"fc{i}"]["b"]
        if i < 2:
            h = F.relu(h)
    return h


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def grad_fn(apply, params: Params, x: torch.Tensor, y: torch.Tensor):
    """Gradient of mean CE loss — the g_k of paper eq. (2)."""

    def loss(p):
        return xent_loss(apply(p, x), y)

    return torch.func.grad(loss)(params)


def part_grads(apply, params: Params, xs: torch.Tensor, ys: torch.Tensor):
    """Each part's :func:`grad_fn` at once: ``xs`` (K, b, ...), ``ys``
    (K, b) → a tree like ``params`` with a leading K axis on every leaf
    (``torch.func.vmap`` over the parts, as the reference's
    ``jax.vmap``)."""
    return torch.func.vmap(lambda x, y: grad_fn(apply, params, x, y))(xs, ys)
