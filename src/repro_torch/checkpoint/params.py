"""Flat-key parameter layout shared with the reference's checkpoints.

The port's own copy of the ``.npz`` key scheme of
``repro.checkpoint.store`` (``_SEP = "/"``, ``_flatten``,
``_unflatten``): a nested dict of arrays maps to ``{"a/b/c": array}``.
``params_from_numpy`` carries weights saved (or flattened) by the JAX
package into the port's nested dict of tensors under the same keys;
``params_to_numpy`` goes back; ``classic_params_from_reference``
carries the paper models' weights (``models.classic``).

Under tensor parallelism a rank holds a slice of each model-sharded
leaf (``dist.sharding.shard_axis``): :func:`shard_params` cuts a rank's
slices out of full arrays and :func:`gather_params` rebuilds the full
arrays from every rank's, both by flat key, so a checkpoint holds the
full arrays whatever the degree that wrote it.  Under pipeline
parallelism a rank's ``groups`` leaves are also its stage's block of
their leading axis (``dist.sharding.stage_axes``): both cut and gather
that axis too (``pp``/``stage``, ``stage``/``stage_axes``); under FSDP
a leaf is also a data rank's block on its "data" dim
(``dist.sharding.data_axes``; ``data``/``data_rank``, ``data``/
``data_axes``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

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


def _block(n: int, tp: int, rank: int) -> slice:
    per = n // tp
    return slice(rank * per, (rank + 1) * per)


def shard_array(arr, axis: Optional[int], tp: int, rank: int):
    """Rank ``rank``'s slice of ``arr`` on ``axis``, a contiguous copy,
    for numpy arrays and tensors alike; ``arr`` itself when ``axis`` is
    None (replicated)."""
    if axis is None or tp <= 1:
        return arr
    idx = [slice(None)] * arr.ndim
    idx[axis] = _block(arr.shape[axis], tp, rank)
    part = arr[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def shard_params(flat_np: Dict[str, np.ndarray], cfg, tp: int, rank: int,
                 axes: Optional[Dict[str, Optional[int]]] = None, *,
                 pp: int = 1, stage: int = 0,
                 stage_axes: Optional[Dict[str, Optional[int]]] = None,
                 data: int = 1, data_rank: int = 0,
                 data_axes: Optional[Dict[str, Optional[int]]] = None
                 ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s slices of full flat-key arrays (params, or any
    tree whose keys ``axes`` maps; default the params' axes of ``cfg`` at
    ``tp``), with ``pp > 1`` stage ``stage``'s block of them
    (``stage_axes``, default the params' of ``cfg``), and with ``data >
    1`` data rank ``data_rank``'s FSDP block (``data_axes``, default the
    params' of ``cfg``) → flat ``{key: array}``."""
    from repro_torch.dist import sharding

    axes = sharding.param_axes(cfg, tp) if axes is None else axes
    if pp > 1 and stage_axes is None:
        stage_axes = sharding.stage_axes(cfg, pp)
    if data > 1 and data_axes is None:
        data_axes = sharding.data_axes(cfg, data)
    return {k: shard_array(shard_array(shard_array(
        v, axes.get(k), tp, rank), (stage_axes or {}).get(k), pp, stage),
        (data_axes or {}).get(k), data, data_rank)
        for k, v in flat_np.items()}


def gather_params(flat: Dict[str, torch.Tensor], cfg, ctx,
                  axes: Optional[Dict[str, Optional[int]]] = None,
                  stage=None,
                  stage_axes: Optional[Dict[str, Optional[int]]] = None,
                  data=None,
                  data_axes: Optional[Dict[str, Optional[int]]] = None
                  ) -> Dict[str, np.ndarray]:
    """The full arrays of every rank's flat-key slices (collective over
    ``ctx``'s group, and ``stage``'s and ``data``'s, the "stage" and the
    FSDP contexts, when they are active: every rank calls it with the
    same keys) → flat ``{key: full}`` host numpy arrays (bfloat16 as
    float32), gathered one leaf at a time."""
    from repro_torch.dist import sharding

    axes = sharding.param_axes(cfg, ctx.tp) if axes is None else axes
    staged = stage is not None and stage.active
    if staged and stage_axes is None:
        stage_axes = sharding.stage_axes(cfg, stage.tp)
    fsdp = data is not None and data.active
    if fsdp and data_axes is None:
        data_axes = sharding.data_axes(cfg, data.tp)
    out = {}
    for k, v in flat.items():
        ax = axes.get(k)
        full = v.detach()
        if fsdp and data_axes.get(k) is not None:
            full = data.gather(full, data_axes[k])
        if ax is not None and ctx.active:
            full = ctx.gather(full, ax)
        if staged and stage_axes.get(k) is not None:
            full = stage.gather(full, stage_axes[k])
        full = full.cpu()
        out[k] = (full.float() if full.dtype == torch.bfloat16
                  else full).numpy()
    return out


def leaf_keys(tree: Any):
    """The flat keys of ``tree``'s leaves in :func:`repro_torch._tree.
    leaves` order (sorted dict keys)."""
    from repro_torch import _tree

    return _tree.leaves(_unflatten({k: k for k in _flatten(tree)}))
