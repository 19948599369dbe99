"""Rank bodies of the port's FSDP tests (no jax here).

The tests run these in the ranks of ``repro_torch.dist.launch.run_ranks``
over gloo on the CPU; the spawned ranks import this module by name.  A
session here is the llama3-8b smoke config in float32 on a homogeneous
cluster whose pods and workers are ranks of their own (``pod_ranks =
pods``, ``data_ranks = data``), so FSDP stores the params and the
optimizer state over the data ranks unless ``fsdp=False``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.checkpoint.params import _flatten, _unflatten
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.sharding import state_axis

#: the session settings (tests/torch_reference.py's, sgd swapped per case)
SESSION = dict(seq_len=16, lr=0.05, total_steps=4, seed=0)
FIT = dict(force_drop_edge=1, force_drop_step=2)
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")
MODES = (("coded", ""), ("coded_q", "int8"))


def f32_cfg():
    return dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")


def session(pods, data, mode, comp, optimizer, fsdp, **kw):
    from repro_torch.api import CodedCluster, CodedSession, \
        planner_for_scheme

    planner = planner_for_scheme("hgc", 1 if pods > 1 else 0, 1)
    opts = dict(SESSION, optimizer=optimizer)
    opts.update(kw)
    return CodedSession(CodedCluster.homogeneous(pods, data), f32_cfg(),
                        planner=planner, mode=mode, grad_compression=comp,
                        device="cpu", verbose=False, fsdp=fsdp, **opts)


def _numel(tree) -> int:
    return sum(t.numel() for t in _tree.leaves(tree))


def expected_blocks(s) -> dict:
    """The elements a rank of ``s`` holds by the slice arithmetic: each
    leaf's whole size (params from the gathered arrays, the optimizer
    state made for them on ``meta``), over the data count where its
    "data" dim is split (``state_axis`` maps the params' dims onto the
    state)."""
    data = s._data.tp if s._data.active else 1
    axes = s._data_axes
    full = s.full_params()
    state = _flatten(s._optimizer.init(_unflatten(
        {k: torch.empty(v.shape, device="meta") for k, v in full.items()})))
    return {"params": sum(v.size // (data if axes.get(k) is not None else 1)
                          for k, v in full.items()),
            "state": sum(v.numel() // (
                data if state_axis(k, axes) is not None else 1)
                for k, v in state.items())}


def parity_run(pods, data, cases):
    """Each case ``(mode, comp, optimizer)`` twice, ``fsdp`` False then
    True: 4 steps with edge 1 dropped at step 2 (where there are two
    pods) → per case and ``fsdp``: the losses, the elements this rank
    holds and the slice arithmetic's, and (rank 0) the full params."""
    torch.set_num_threads(1)
    out = {}
    for mode, comp, opt in cases:
        for fsdp in (False, True):
            s = session(pods, data, mode, comp, opt, fsdp)
            fit = FIT if pods > 1 else {}
            s.fit(4, **fit)
            rec = {"losses": list(s.losses),
                   "held": {"params": _numel(s.params),
                            "state": _numel(s.opt_state)},
                   "want": expected_blocks(s),
                   "active": s._data.active,
                   "params": s.full_params()}
            if dist.get_rank():
                rec.pop("params")
            out[(mode, comp, opt, fsdp)] = rec
    return out


def checkpoint_run(pods, data, ck_dir, fsdp=True, resume=False, stop=0):
    """adamw coded_q int8 with a checkpoint every 2 steps into
    ``ck_dir``, to step 4 (``stop``: a kill after it; ``resume``: from
    the directory) → losses, the first step run and (rank 0) the full
    params and optimizer state."""
    torch.set_num_threads(1)
    s = session(pods, data, "coded_q", "int8", "adamw", fsdp,
                checkpoint_dir=ck_dir, checkpoint_every=2,
                keep_checkpoints=1, resume=resume)
    start = s._step
    s.fit(4, stop_after=stop, **FIT)
    out = {"start": start, "losses": list(s.losses),
           "active": s._data.active, "params": s.full_params(),
           "state": s._gather(_flatten(s.opt_state), "state")}
    if dist.is_initialized() and dist.get_rank():
        return None
    return out


def reference_run(init, runs):
    """The reference's coded runs (``tests/torch_reference.py``: sgd, 4
    steps, edge 1 dropped at step 2, hgc (1, 1) on homogeneous(2, 4)) from
    its initial params, one rank a (pod, data) group → rank 0's losses
    by run name."""
    from repro_torch.api import CodedCluster, CodedSession, \
        planner_for_scheme

    torch.set_num_threads(1)
    out = {}
    for mode, comp in runs:
        s = CodedSession(CodedCluster.homogeneous(2, 4), f32_cfg(),
                         planner=planner_for_scheme("hgc", 1, 1), mode=mode,
                         grad_compression=comp, device="cpu", verbose=False,
                         params=init, optimizer="sgd", **SESSION)
        assert s._data.active and s._mesh.data_ranks == 4
        out[mode + comp] = s.fit(4, **FIT)["losses"]
    return out if dist.get_rank() == 0 else None
