"""The reference's optimizers on nested dicts of tensors.

PyTorch counterpart of ``repro.optim.optimizers``: plain tensor ops on
the param tree (not ``torch.optim``), so each update is the reference's
arithmetic.  ``Optimizer`` is three functions:

    init(params)                          → state tree
    update(grads, state, params, lr, wd)  → (updates, new_state)
    apply_(grads, state, params, lr, wd)  → new_state

``update`` is the reference's API (updates applied as ``p + u``).
``apply_`` runs the same per-leaf arithmetic one leaf at a time, adds
each update into its parameter in place, copies the leaf's new state
into the old state's tensors and drops the leaf's gradient, so a step
never holds a second copy of the params or the state: what lets the
full-width model train on one card.  Its ``grads`` is a list in
:func:`repro_torch._tree.leaves` order, emptied as it goes.

Under tensor parallelism each rank updates its own slices, so every
reduction over a leaf must span the ranks: ``global_norm`` (and the
clip) all-reduce the sharded leaves' square sums over "model" and count
a replicated leaf once; adafactor's row and column statistics and its
update-RMS clip all-reduce over the sharded axis.  ``ctx`` is the
:class:`~repro_torch.dist.sharding.ShardCtx` and ``axes`` the split
axis of each leaf (None: replicated), in leaf order.  Under pipeline
parallelism ``stage`` (the context over the "stage" group) and
``stage_axes`` (the ``groups`` stacks' leading axis) add the same
reductions over "stage": a leaf may be split on both axes.  Under FSDP
``data`` gives each leaf's ``(axis, context)`` over the ranks it is
stored split across (None: whole): the norm completes each leaf's
square sum over them first, and adafactor's means over a split dim
span them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import _tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    apply_: Callable[..., PyTree]


def _active(ctx) -> bool:
    return ctx is not None and ctx.active


def global_norm(tree: PyTree, ctx=None,
                axes: Optional[Sequence[Optional[int]]] = None,
                stage=None,
                stage_axes: Optional[Sequence[Optional[int]]] = None,
                data: Optional[Sequence] = None) -> torch.Tensor:
    """√Σ over every leaf of its square sum; under TP the sharded leaves'
    part is all-reduced over "model" and each replicated leaf counted
    once, and under PP the stage-split leaves' part over "stage".  Under
    FSDP (``data``) each split leaf's square sum is first summed over its
    ranks (one all-reduce a context, of the stacked sums)."""
    flat = _tree.leaves(tree)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in flat]
    by_ctx: Dict[int, Tuple[Any, List[int]]] = {}
    for i, d in enumerate(data or ()):
        if d is not None and _active(d[1]):
            by_ctx.setdefault(id(d[1]), (d[1], []))[1].append(i)
    for c, idx in by_ctx.values():
        for i, v in zip(idx, c.reduce_sum(torch.stack([sq[i] for i in idx]))
                        .unbind(0)):
            sq[i] = v
    if not _active(ctx) and not _active(stage):
        return torch.sqrt(torch.sum(torch.stack(sq)))
    zero = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    m_split = [_active(ctx) and ax is not None for ax in axes or
               [None] * len(sq)]
    s_split = [_active(stage) and ax is not None for ax in stage_axes or
               [None] * len(sq)]

    def part(m, st):
        qs = [q for q, a, b in zip(sq, m_split, s_split) if (a, b) == (m, st)]
        return torch.sum(torch.stack(qs)) if qs else zero

    # split over "model" first (each stage's own blocks), then "stage"
    on_model = part(True, False), part(True, True)
    if any(m_split):
        on_model = ctx.reduce_sum(torch.stack(on_model)).unbind(0)
    total = part(False, False) + on_model[0]
    if any(s_split):
        total = total + stage.reduce_sum(part(False, True) + on_model[1])
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _tree.map(lambda g: g * scale.to(g.dtype), grads)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         ctx=None, axes=None, stage=None,
                         stage_axes=None, data=None) -> List[torch.Tensor]:
    """:func:`clip_by_global_norm` in place on a list of leaves (the same
    arithmetic, no second copy of the gradient); under TP, PP and FSDP
    the norm is the global one (:func:`global_norm`)."""
    norm = global_norm(grads, ctx, axes, stage, stage_axes, data)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr_at(step)`` → 0-dim float32 tensor, as the reference's f32
    schedule."""

    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr_at


# ----------------------------------------------------------------------
class _Split:
    """How one leaf is split over the "model" ranks (``axis``, ``ctx``),
    the "stage" ranks (``stage_axis``, ``stage``) and its FSDP ranks
    (``data``: ``(axis, context)``), for the reductions of its update: a
    mean over a split dim is the mean of the ranks' means (equal
    blocks)."""

    def __init__(self, axis: Optional[int] = None, ctx=None, ndim: int = 0,
                 stage_axis: Optional[int] = None, stage=None, data=None):
        data = data or (None, None)
        self.splits = [(ax % ndim, c) for ax, c in ((axis, ctx),
                                                    (stage_axis, stage),
                                                    data)
                       if ax is not None and _active(c)]
        self.ndim = ndim

    def mean(self, x, dim: int, leaf_dim: Optional[int] = None,
             keepdim: bool = False):
        """``x.mean(dim)``; ``leaf_dim`` is that dim in the leaf's
        coordinates (default ``dim``: ``x`` has the leaf's shape)."""
        m = x.mean(dim, keepdim=keepdim)
        for ax, c in self.splits:
            if (dim if leaf_dim is None else leaf_dim) % self.ndim == ax:
                m = c.reduce_sum(m) / c.tp
        return m

    def mean_all(self, x):
        m = torch.mean(x)
        for _, c in self.splits:
            m = c.reduce_sum(m) / c.tp
        return m


_WHOLE = _Split()


def _optimizer(name: str, slots: Tuple[str, ...], init_leaf, leaf,
               counted: bool) -> Optimizer:
    """An optimizer from its per-leaf rule.

    ``init_leaf(p)`` → the leaf's state, a dict over ``slots``;
    ``leaf(g, p, st, lr, wd, t, split)`` → ``(update, new_st)``, with
    ``split`` the leaf's :class:`_Split`.  The state tree
    is ``{slot: tree of that slot}`` (+ ``"t"``, an int32 step count,
    when ``counted``), laid out as the reference's.
    """

    def init(params):
        per = [init_leaf(p) for p in _tree.leaves(params)]
        state: Dict[str, Any] = {
            s: _tree.unflatten_like(params, [d[s] for d in per])
            for s in slots}
        if counted:
            dev = _tree.leaves(params)[0].device
            state["t"] = torch.zeros((), dtype=torch.int32, device=dev)
        return state

    def _per_leaf(state, params):
        """``(param leaves, each leaf's state dict, the next t)``."""
        flat_p = _tree.leaves(params)
        per = [_tree.leaves_like(state[s], params) for s in slots]
        sts = [{s: per[j][i] for j, s in enumerate(slots)}
               for i in range(len(flat_p))]
        return flat_p, sts, (state["t"] + 1 if counted else None)

    def update(grads, state, params, lr, weight_decay=0.0):
        flat_p, sts, t = _per_leaf(state, params)
        outs = [leaf(g, p, st, lr, weight_decay, t, _WHOLE)
                for g, p, st in zip(_tree.leaves(grads), flat_p, sts)]
        new_state = {s: _tree.unflatten_like(params, [n[s] for _, n in outs])
                     for s in slots}
        if counted:
            new_state["t"] = t
        return _tree.unflatten_like(params, [u for u, _ in outs]), new_state

    def apply_(grads: List, state, params, lr, weight_decay=0.0, *,
               ctx=None, axes=None, stage=None, stage_axes=None, data=None):
        flat_p, sts, t = _per_leaf(state, params)
        for i, (p, st) in enumerate(zip(flat_p, sts)):
            split = _Split(axes[i] if axes is not None else None, ctx,
                           p.ndim, stage_axes[i] if stage_axes is not None
                           else None, stage,
                           data[i] if data is not None else None)
            u, nst = leaf(grads[i], p, st, lr, weight_decay, t, split)
            # the new state goes into the old tensors, so old and new are
            # never both held beyond one leaf
            grads[i] = None
            with torch.no_grad():
                p.add_(u)
                _tree.map(lambda old, new: old.copy_(new), st, nst)
        if counted:
            state["t"] = t
        return state

    return Optimizer(name, init, update, apply_)


def _f32(x):
    return x.to(torch.float32)


def sgd() -> Optimizer:
    def leaf(g, p, st, lr, wd, t, split):
        return -(lr * (_f32(g) + wd * _f32(p))).to(p.dtype), {}

    return _optimizer("sgd", (), lambda p: {}, leaf, counted=False)


def momentum(beta: float = 0.9) -> Optimizer:
    def init_leaf(p):
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    def leaf(g, p, st, lr, wd, t, split):
        m = beta * st["m"] + _f32(g)
        return -(lr * (m + wd * _f32(p))).to(p.dtype), {"m": m}

    return _optimizer("momentum", ("m",), init_leaf, leaf, counted=False)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init_leaf(p):
        z = lambda: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": z(), "v": z()}

    def leaf(g, p, st, lr, wd, t, split):
        g = _f32(g)
        m = b1 * st["m"] + (1 - b1) * g
        v = b2 * st["v"] + (1 - b2) * torch.square(g)
        tf = t.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, tf)
        c2 = 1.0 - torch.pow(b2, tf)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        step = step + wd * _f32(p)
        return -(lr * step).to(p.dtype), {"m": m, "v": v}

    return _optimizer("adamw", ("m", "v"), init_leaf, leaf, counted=True)


def adafactor(eps: float = 1e-30, clip_thresh: float = 1.0) -> Optimizer:
    """Factored second moments (Shazeer & Stern), β1 = 0: matrices keep
    one row and one column accumulator over their trailing two dims.
    Under TP the means over a split dim and the update's RMS span the
    ranks (``split``)."""

    def init_leaf(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"acc": {"vr": torch.zeros(p.shape[:-1], **kw),
                            "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              **kw)}}
        return {"acc": {"v": torch.zeros(p.shape, **kw)}}

    def leaf(g, p, st, lr, wd, t, split):
        beta2 = 1.0 - torch.pow(t.to(torch.float32), -0.8)
        acc = st["acc"]
        gf = _f32(g)
        g2 = torch.square(gf) + eps
        if p.ndim >= 2:
            vr = beta2 * acc["vr"] + (1 - beta2) * split.mean(g2, -1)
            vc = beta2 * acc["vc"] + (1 - beta2) * split.mean(g2, -2)
            # vr's last dim is the leaf's second to last
            denom = torch.clamp(split.mean(vr, -1, leaf_dim=-2,
                                           keepdim=True), min=eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            step = gf / torch.sqrt(vhat + eps)
            new_acc = {"vr": vr, "vc": vc}
        else:
            v = beta2 * acc["v"] + (1 - beta2) * g2
            step = gf / torch.sqrt(v + eps)
            new_acc = {"v": v}
        rms = torch.sqrt(split.mean_all(torch.square(step)) + eps)
        step = step / torch.clamp(rms / clip_thresh, min=1.0)
        step = step + wd * _f32(p)
        return (-(lr * step)).to(p.dtype), {"acc": new_acc}

    return _optimizer("adafactor", ("acc",), init_leaf, leaf, counted=True)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {
        "sgd": sgd,
        "momentum": momentum,
        "adamw": adamw,
        "adafactor": adafactor,
    }[name](**kw)
