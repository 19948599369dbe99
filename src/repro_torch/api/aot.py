"""Ahead-of-time analysis of one (arch × shape × mesh) cell: the port's
counterpart of ``repro.api.aot``.

The reference lowers and compiles the cell's step with XLA on 256 or
512 forced host devices and reads memory and cost from the compiled
module.  The port has no compiler: :func:`run_cell` runs ONE rank's
view of the step eagerly on the ``meta`` device (shapes only: no
memory, no kernel) under ``launch.op_analysis.OpCounter``, with the
rank's batch rows and its "model" slices, and its "model" collectives
on counting groups (``dist.sharding.CountingGroup``) of the production
layout (``launch.mesh``).  It needs no devices and no ``XLA_FLAGS``.

The rank's view of the production mesh: the "model" axis of 16 ranks
runs tensor parallelism at the largest degree dividing 16 that the
config admits (``dist.sharding.validate_tp``: 16 for most configs; 8,
4 or 2 where the heads do not split 16 ways, the rest of the axis then
splitting the batch, data-parallel); every other rank of the mesh is
data-parallel, and the batch's rows split over them (a batch smaller
than that is replicated).  Train cells run ``launch.steps.
make_train_step`` with the gradients averaged over the data-parallel
ranks, which the reference's pjit step has XLA insert, recorded as one
all-reduce a whole gradient leaf (an FSDP block's: below) and one for
the loss; prefill and decode cells run ``make_prefill_step`` /
``make_serve_step``.

Constants are the H100 SXM's (NVIDIA's data sheet): 989e12 bf16 dense
FLOP/s, 3.35e12 B/s of HBM, NVLink 450e9 B/s each way within a host of 8,
and the inter-host link ``launch.mesh`` assumes (50e9 B/s a card).

Options, against the reference's:

  * ``fsdp=True`` (the reference's default; decode cells never shard
    over "data"): train and prefill cells store the params (and the
    optimizer state) as rank 0's FSDP blocks by the reference's fitted
    "data" entries (``launch.mesh.fsdp_layout``); the step gathers each
    split leaf over its ranks once at entry (all-gathers under the
    ``fsdp.collective`` span), and a train step reduce-scatters the
    accumulated gradient of a split leaf over them (then all-reduces the
    block over the other data-parallel ranks) and updates the blocks.
    The predicted peak holds the blocks and the transient whole copies;
  * ``mode="dp_only"``: no tensor parallelism, the batch over all ranks,
    FSDP over "data" and "model" together;
  * ``moe_ep_axis="data"``: the experts stored over "data" on their
    expert dim (whole on "model"), gathered like any FSDP leaf;
  * ``sharded_accum=True``: each microbatch's gradient reduced into the
    block-shaped float32 accumulator (``launch.steps.make_train_step``);
  * ``remat``, ``remat_policy`` (``"save_block_outputs"`` keeps each
    sublayer's post-all-reduce output and recomputes the rest),
    ``kv_repeat`` (the reference's head padding to 16) and ``seq_shard``
    (sequence parallelism on the "model" axis) change what the port
    runs; ``microbatch`` is the accumulation size of the global batch,
    so a rank accumulates over ``microbatch / dp`` of its rows;
  * ``flash`` selects nothing: the port's full-sequence attention is
    always the flash kernel, whose backward recomputes the scores as the
    reference's ``flash=True`` does.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import get_config, shape_applicable
from repro_torch.dist import sharding as sh
from repro_torch.launch import op_analysis
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (
    NVLINK_BW,
    fsdp_layout,
    make_production_mesh,
)

# H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # bytes/s
LINK_BW = NVLINK_BW  # bytes/s each way within a host (IB_BW between)

def count_step(fn: Callable, *args, arguments: Any = None,
               tally: Optional[sh.CollectiveTally] = None
               ) -> Tuple[Any, Dict]:
    """``fn(*args)`` under an ``OpCounter`` whose arguments are
    ``arguments`` (default ``args``) → (its output, the
    ``analysis_record`` with the counter's ``memory_analysis``)."""
    counter = op_analysis.OpCounter(args if arguments is None
                                    else arguments)
    with counter:
        out = fn(*args)
    rec = op_analysis.analysis_record(counter, tally)
    rec["memory_analysis"] = counter.memory_analysis()
    return out, rec


def model_degree(cfg, axis: int) -> int:
    """The tensor-parallel degree on a "model" axis of ``axis`` ranks:
    the largest divisor of ``axis`` the config admits."""
    for tp in range(axis, 0, -1):
        if axis % tp:
            continue
        try:
            sh.validate_tp(cfg, tp)
        except ValueError:
            continue
        return tp
    return 1


def _long(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's batches carry int64 ids (``CodedSession._to_device``)."""
    return {k: (v.long() if v.dtype == torch.int32 else v)
            for k, v in batch.items()}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    fsdp: bool = True,
    microbatch: int = 32,
    remat: bool = True,
    flash: bool = False,
    sharded_accum: bool = False,
    kv_repeat: bool = False,
    remat_policy: str = "full",
    mode: str = "2d",
    moe_ep_axis: str = "model",
    seq_shard: bool = False,
    verbose: bool = True,
) -> Dict:
    """Count one rank's step of one (arch × shape × mesh) cell on the
    ``meta`` device; returns the record (the reference's keys)."""
    cfg = get_config(arch)
    overrides = {}
    if not remat:
        overrides["remat"] = False
    if flash:
        overrides["flash"] = True
    if remat_policy != "full":
        overrides["remat_policy"] = remat_policy
    if kv_repeat and cfg.n_kv_heads and cfg.n_heads >= 8:
        # the reference's head alignment to the TP degree: KV heads
        # replicated to 16, Q heads zero-padded to a multiple of 16
        overrides["n_kv_heads"] = 16
        if cfg.n_heads % 16:
            overrides["n_heads"] = -(-cfg.n_heads // 16) * 16
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    rec = {
        "arch": arch, "shape": shape_name,
        "multi_pod": multi_pod, "mesh": str(dict(mesh.shape)),
        "fsdp": fsdp, "microbatch": microbatch, "remat": remat,
        "flash": flash, "sharded_accum": sharded_accum,
        "kv_repeat": kv_repeat, "remat_policy": remat_policy,
        "mode": mode, "moe_ep_axis": moe_ep_axis,
        "seq_shard": seq_shard,
    }
    try:
        if seq_shard and mode == "dp_only":
            raise ValueError(
                "seq_shard needs tensor parallelism (mode='dp_only' "
                "has no model-sharded activations to seq-shard)")
        if mode not in ("2d", "dp_only"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        ep = moe_ep_axis if moe_ep_axis in mesh.shape else "model"
        tp = 1 if mode == "dp_only" else model_degree(cfg,
                                                      mesh.shape["model"])
        dp = mesh.size // tp
        if seq_shard:
            sh.validate_seq_shard(cfg, tp, shape.seq_len)
        tally = sh.CollectiveTally()
        tp_group = mesh.counting_group(tuple(range(tp)), tally)
        dp_ranks = tuple(range(0, mesh.size, tp))
        dp_group = mesh.counting_group(dp_ranks, tally)
        ctx = sh.ShardCtx(tp=tp, rank=0, group=tp_group,
                          seq_shard=seq_shard) if tp > 1 else sh.NULL_CTX
        fsdp_split = None
        if fsdp and shape.kind in ("train", "prefill"):
            fsdp_split = fsdp_layout(mesh, cfg, dp_ranks, tally, mode=mode,
                                     moe_ep_axis=ep)
        rows = max(shape.global_batch // dp, 1)
        rec.update(tp=tp, dp=dp, rows_per_rank=rows,
                   fsdp_leaves=sum(v is not None
                                   for v in (fsdp_split or {}).values()))
        batch = steps_lib.input_specs(cfg, shape, batch=rows)
        if shape.kind == "train":
            tcfg = TrainConfig(microbatch=max(microbatch // dp, 1)
                               if microbatch else 0)
            params, opt = steps_lib.abstract_state(
                cfg, tcfg, tp=tp, moe_ep_axis=ep, fsdp=fsdp_split)
            for p in _tree.leaves(params):
                p.requires_grad_(True)

            step = steps_lib.make_train_step(
                cfg, tcfg, ctx=ctx, dp_group=dp_group if dp > 1 else None,
                fsdp=fsdp_split, sharded_accum=sharded_accum,
                moe_ep_axis=ep)
            _, ana = count_step(step, params, opt, _long(batch), 0,
                                tally=tally)
        else:
            params = tf_params(cfg, tp, moe_ep_axis=ep)
            if shape.kind == "prefill":
                params = steps_lib.fsdp_blocks(params, fsdp_split)
                step = steps_lib.make_prefill_step(cfg, ctx, fsdp_split)
                with torch.no_grad():
                    _, ana = count_step(step, params, _long(batch),
                                        tally=tally)
            else:
                cache = steps_lib.abstract_cache(cfg, shape, batch=rows,
                                                 tp=tp)
                step = steps_lib.make_serve_step(cfg, ctx)
                with torch.no_grad():
                    _, ana = count_step(step, params, cache,
                                        batch["token"].long(),
                                        tally=tally)
        t_trace = time.time() - t0
        rec.update({
            "status": "ok",
            # no lowering or compile: the counted eager run on meta
            "lower_s": round(t_trace, 1),
            "compile_s": 0.0,
            "xla_flops": -1.0,
            "xla_bytes": -1.0,
            "flops": ana["flops"],
            "matmul_flops": ana["matmul_flops"],
            "bytes_accessed": ana["bytes_accessed"],
            "bytes_accessed_bf16eq": ana["bytes_accessed_bf16eq"],
            "attn_bytes_bf16eq": ana["attn_bytes_bf16eq"],
            "kernels": ana["kernels"],
            "collectives": ana["collectives"],
            "collective_operand_bytes": ana["collective_operand_bytes"],
            "collective_link_bytes": ana["collective_link_bytes"],
            "collective_link_bytes_bf16eq":
                ana["collective_link_bytes_bf16eq"],
            "cross_pod_link_bytes": ana["cross_pod_link_bytes"],
            "n_devices": mesh.size,
            "memory_analysis": ana["memory_analysis"],
        })
        rec["roofline"] = roofline(cfg, shape, ana, mesh.size)
        if verbose:
            _print(rec)
    except Exception as e:  # noqa: BLE001 — the record carries it
        rec.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
        if verbose:
            print(f"[dryrun] {arch} × {shape_name}: FAILED {rec['error']}")
    return rec


def tf_params(cfg, tp: int = 1, rank: int = 0,
              moe_ep_axis: str = "model"):
    """Serving weights on ``meta``: the working copy in ``cfg.dtype``, as
    ``launch.serve`` draws them (this ``rank``'s slices at ``tp``; the
    experts whole on "model" with ``moe_ep_axis="data"``)."""
    from repro_torch.checkpoint.params import (
        _flatten,
        _unflatten,
        shard_array,
    )
    from repro_torch.models import transformer as tf

    axes = sh.param_axes(cfg, tp, moe_ep_axis)
    return _unflatten({k: shard_array(v, axes[k], tp, rank).clone()
                       for k, v in _flatten(tf.init_params(
                           cfg, device="meta")).items()})


def roofline_terms(ana: Dict) -> Dict:
    """The roofline terms (seconds) of one counted step: compute, memory
    (bf16-equivalent; raw; and ``memory_s_pallas``, with the attention
    kernels' score traffic retired) and the collectives, each group at
    its own link's rate (NVLink or the inter-host link)."""
    return {
        "compute_s": ana["flops"] / PEAK_FLOPS,
        "memory_s": ana["bytes_accessed_bf16eq"] / HBM_BW,
        "memory_s_raw": ana["bytes_accessed"] / HBM_BW,
        "memory_s_pallas": (ana["bytes_accessed_bf16eq"]
                            - ana["attn_bytes_bf16eq"]) / HBM_BW,
        "collective_s": sum(v["link_s"]
                            for v in ana["collectives"].values()),
    }


def roofline(cfg, shape, ana: Dict, n_devices: int) -> Dict:
    """:func:`roofline_terms`, the model FLOPs of the cell as the
    reference computes them, and the dominant term."""
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    _, active_p = cfg.param_counts()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * active_p \
        * tokens
    r = roofline_terms(ana)
    r.update({
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / n_devices,
        "useful_flops_ratio": (model_flops / n_devices)
        / max(ana["flops"], 1.0),
    })
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: r[k])
    return r


def _print(rec: Dict) -> None:
    r = rec["roofline"]
    print(f"[dryrun] {rec['arch']} × {rec['shape']} "
          f"({'multi' if rec['multi_pod'] else 'single'}-pod, tp "
          f"{rec['tp']} × dp {rec['dp']}): OK  traced in "
          f"{rec['lower_s']}s")
    print(f"  memory_analysis: {rec['memory_analysis']}")
    print(f"  flops/device: {rec['flops']:.3e}  "
          f"bytes/device: {rec['bytes_accessed']:.3e}  "
          f"coll-link bytes: {rec['collective_link_bytes']:.3e}")
    print(f"  roofline: compute {r['compute_s']*1e3:.1f}ms  "
          f"memory {r['memory_s']*1e3:.1f}ms  "
          f"collective {r['collective_s']*1e3:.1f}ms  "
          f"dominant={r['dominant']}  "
          f"useful-flops-ratio {r['useful_flops_ratio']:.3f}")
