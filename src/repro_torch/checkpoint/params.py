"""Flat-key parameter layout shared with the reference's checkpoints.

The port's own copy of the ``.npz`` key scheme of
``repro.checkpoint.store`` (``_SEP = "/"``, ``_flatten``,
``_unflatten``): a nested dict of arrays maps to ``{"a/b/c": array}``.
``params_from_numpy`` carries weights saved (or flattened) by the JAX
package into the port's nested dict of tensors under the same keys;
``params_to_numpy`` goes back; ``classic_params_from_reference``
carries the paper models' weights (``models.classic``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [fix(node[f"#{i}"]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` that shares no memory with it
    (the port updates params and optimizer state in place).  A CUDA
    tensor is a copy anyway, so a writable array goes up directly."""
    arr = np.asarray(arr)
    if torch.device(device).type == "cpu" or not arr.flags.writeable:
        arr = np.array(arr)  # own, writable copy
    return torch.from_numpy(arr).to(device)


def params_from_numpy(flat: Dict[str, np.ndarray], device,
                      dtype: torch.dtype = torch.float32) -> Any:
    """Flat ``{key: ndarray}`` → nested dict of tensors on ``device``.

    Floating tensors of two or more dimensions land in ``dtype`` — the
    working copy ``transformer.cast_params`` would make; vectors stay
    float32, as in the reference.
    """
    out = {}
    for key, arr in flat.items():
        t = tensor_from_numpy(arr, device)
        if t.is_floating_point():
            t = t.to(dtype if t.ndim >= 2 else torch.float32)
        out[key] = t
    return _unflatten(out)


def params_to_numpy(params: Any) -> Dict[str, np.ndarray]:
    """Nested dict of tensors → flat ``{key: ndarray}`` (host copies).

    numpy has no bfloat16: such tensors come back as float32, exactly.
    """
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: host(v) for k, v in _flatten(params).items()}


def classic_params_from_reference(tree: Dict[str, Any], device) -> Any:
    """The reference's ``models.classic`` params (a nested dict of arrays)
    → the port's, float32 on ``device``: a convolution's HWIO weight
    becomes OIHW; every other leaf keeps its shape (the FC weights are
    (in, out) in both, and the port flattens in the reference's
    (H, W, C) order, so ``fc0``'s rows carry over unpermuted)."""
    def leaf(key, arr):
        arr = np.asarray(arr, np.float32)
        if key.startswith("conv") and key.endswith(_SEP + "w"):
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        return tensor_from_numpy(arr, device)

    return _unflatten({k: leaf(k, v) for k, v in _flatten(tree).items()})
