"""Weights from ``--seed``, made on the device, one call a leaf.

The benchmark hands the same weights to the program and to the plain
reference: every leaf of the layout below is drawn N(0, 0.02²) by a
``torch.Generator`` seeded from the run's seed and the leaf's key (norm
scales are ones), in the dtype it is used in.  Layers are stacked along
a leading axis, so a model is about a dozen calls.  Seeding each leaf by
its key lets the reference draw any one leaf again, alone.

The layout is the port's parameter format (flat keys joined by ``.``);
the harness checks the program's tree against it before handing the
weights over.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

STD = 0.02


def param_shapes(m: Dict) -> Dict[str, Tuple[int, ...]]:
    """Flat key → shape of an attention model with a dense MLP or a
    mixture of experts in every layer (``m``: a configuration's
    ``model`` block)."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    H, Kv, Dh, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    g = "groups.p0."
    out = {"embed.table": (V, d), "final_norm.scale": (d,),
           g + "norm1.scale": (L, d), g + "norm2.scale": (L, d),
           g + "attn.wq": (L, d, H * Dh), g + "attn.wk": (L, d, Kv * Dh),
           g + "attn.wv": (L, d, Kv * Dh), g + "attn.wo": (L, H * Dh, d)}
    if not m.get("tie_embeddings", False):
        out["head.w"] = (d, V)
    E = m.get("n_experts", 0)
    if E:
        out.update({g + "moe.router": (L, d, E),
                    g + "moe.we_g": (L, E, d, ff),
                    g + "moe.we_u": (L, E, d, ff),
                    g + "moe.we_d": (L, E, ff, d)})
    else:
        out.update({g + "mlp.wg": (L, d, ff), g + "mlp.wu": (L, d, ff),
                    g + "mlp.wd": (L, ff, d)})
    return out


def leaf_seed(seed: int, key: str) -> int:
    """A 63-bit generator seed for leaf ``key`` of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{key}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(key: str, shape, seed: int, device, dtype) -> torch.Tensor:
    """Leaf ``key`` of run ``seed`` as a new tensor."""
    t = torch.empty(shape, dtype=dtype, device=device)
    fill_(t, key, seed)
    return t


def fill_(t: torch.Tensor, key: str, seed: int) -> None:
    """Leaf ``key`` of run ``seed`` drawn into ``t``: ones for a norm
    scale, else N(0, 0.02²) from the leaf's own generator on ``t``'s
    device, in ``t``'s dtype."""
    with torch.no_grad():
        if key.endswith(".scale"):
            t.fill_(1.0)
            return
        gen = torch.Generator(device=t.device).manual_seed(
            leaf_seed(seed, key))
        t.normal_(0.0, STD, generator=gen)


def serving_dtype(shape, dtype) -> torch.dtype:
    """Served weights: matrices and stacked vectors in the model's dtype,
    the final norm's vector in float32 (the port's serving layout)."""
    return dtype if len(shape) >= 2 else torch.float32


def flat_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors → ``{dotted key: tensor}``."""
    out = {}
    for k in sorted(tree):
        key = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, key))
        else:
            out[key] = v
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{dotted key: tensor}`` → a nested dict."""
    root: Dict = {}
    for key, v in flat.items():
        node = root
        *parts, last = key.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return root
