"""The dry run of the port against the reference's (CPU, no devices):

  * ``SHAPES``, ``shape_applicable`` and ``all_cells`` equal the
    reference's;
  * ``launch.steps.input_specs``, ``abstract_state`` and
    ``abstract_cache`` (``meta`` tensors) give every leaf the shape and
    dtype of the reference's ``jax.eval_shape`` ones, for all ten
    full-width configs, by the flat keys of the checkpoint layout; the
    serving cache's dtypes agree too (K/V in ``cfg.dtype``: the
    reference's ``init_cache`` default; its f32 cache is an option of its
    serving path only).  whisper's cache carries one leaf more,
    ``cross_pos`` (ROADMAP.md §3);
  * the roofline's ``model_flops_global`` equals the reference's formula
    for every cell;
  * the op counter's matmul FLOPs for a smoke train, prefill and decode
    step (float32, B 2, S 32) against the dot and convolution FLOPs of
    the reference's same step compiled on one CPU device, read from its
    HLO with ``hlo_analysis``'s parser and trip counts: the port's
    attention kernels count the (query, key) pairs they attend, the
    reference's dense attention multiplies all S × T, so the kernels'
    FLOPs are scaled to all pairs first.  Prefill and decode are equal.
    The train steps differ by two known products, per-op diffs of the
    two steps' matmuls on these configs show, and the test adds them and
    then asks for equality: the port's attention backward recomputes
    Q·Kᵀ over all S × T pairs once a layer, since its flash forward keeps
    only the log-sum-exp (+1.19% llama3-8b, +1.08% granite-moe); the
    reference's HLO contracts the decay gradients of the SSD's two
    three-operand einsums (``S_c``'s and ``y_out``'s) as dots, which
    the port's autograd reaches as a product and a sum, counted as
    pointwise and reduction FLOPs (−0.18% mamba2);
  * the kernels' ``meta`` route counts exactly what ``chip_smoke.py``'s
    bounds count at phase 2's shapes.
"""
import dataclasses
import functools
import importlib.util
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.launch import hlo_analysis
from repro.launch import steps as ref_steps
from repro_torch import _tree
from repro_torch.api import aot
from repro_torch.checkpoint.params import _flatten
from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    get_config,
    get_smoke_config,
    shape_applicable,
)
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.launch import steps
from torch_reference import REPO, few_threads  # noqa: F401 (autouse)


def test_shapes_and_cells_equal_reference():
    assert SHAPES.keys() == ref_base.SHAPES.keys()
    for k, v in SHAPES.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(ref_base.SHAPES[k])
    assert all_cells() == ref_registry.all_cells()
    for a in ARCH_IDS:
        for s in SHAPES:
            assert shape_applicable(get_config(a), SHAPES[s]) == \
                ref_registry.shape_applicable(ref_registry.get_config(a),
                                              ref_base.SHAPES[s])


def _leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_specs_match_reference(arch):
    ref_cfg, cfg = ref_registry.get_config(arch), get_config(arch)
    want_p, want_o = ref_steps.abstract_state(ref_cfg, ref_base.TrainConfig())
    got_p, got_o = steps.abstract_state(cfg, TrainConfig())
    assert all(v.device.type == "meta" for v in _tree.leaves(got_p))
    assert _leaves(got_p) == _leaves(want_p)
    assert _leaves(got_o) == _leaves(want_o)
    for name, shape in SHAPES.items():
        assert _leaves(steps.input_specs(cfg, shape)) == _leaves(
            ref_steps.input_specs(ref_cfg, ref_base.SHAPES[name])), name
    got_c = _leaves(steps.abstract_cache(cfg, SHAPES["decode_32k"]))
    want_c = _leaves(ref_steps.abstract_cache(
        ref_cfg, ref_base.SHAPES["decode_32k"]))
    if cfg.is_encdec:
        assert got_c.pop("cross_pos") == ((), "int32")
    assert got_c == want_c


def test_model_flops_global_equal_reference():
    dummy = dict(flops=1.0, bytes_accessed=0.0, bytes_accessed_bf16eq=0.0,
                 attn_bytes_bf16eq=0.0, collectives={})
    for arch, name, ok, _ in all_cells():
        shape = ref_base.SHAPES[name]
        tokens = shape.global_batch * (
            shape.seq_len if shape.kind in ("train", "prefill") else 1)
        want = (6.0 if shape.kind == "train" else 2.0) * \
            ref_registry.get_config(arch).param_counts()[1] * tokens
        got = aot.roofline(get_config(arch), SHAPES[name], dummy, 256)
        assert got["model_flops_global"] == want, (arch, name)
        assert got["model_flops_per_device"] == want / 256


# ----------------------------------------------------------------------
# matmul FLOPs against the reference's HLO
# ----------------------------------------------------------------------
def _hlo_matmul_flops(text: str) -> float:
    """dot and convolution FLOPs of an HLO module, each loop body times
    its known trip count (``hlo_analysis``'s parser and formulas)."""
    comps, entry, _ = hlo_analysis.parse_module(text)
    memo = {}

    def cost(name):
        if name not in memo:
            ops_, total = comps.get(name, []), 0.0
            sym = {o.name: o for o in ops_}
            for op in ops_:
                if op.kind == "dot":
                    total += hlo_analysis._dot_flops(op, sym)
                elif op.kind == "convolution":
                    total += hlo_analysis._conv_flops(op, sym)
                elif op.kind == "while":
                    body = re.search(r"body=%?([\w.\-]+)", op.line)
                    trip = re.search(r'"known_trip_count":\{"n":"(\d+)"\}',
                                     op.line)
                    total += cost(body.group(1)) * (
                        float(trip.group(1)) if trip else 1.0)
                elif op.kind in ("fusion", "call"):
                    m = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)",
                                  op.line)
                    total += cost(m.group(1)) if m else 0.0
                elif op.kind == "conditional":
                    m = re.search(r"branch_computations=\{([^}]*)\}",
                                  op.line)
                    names = re.findall(r"%([\w.\-]+)", m.group(1)) if m \
                        else []
                    total += max((cost(n) for n in names), default=0.0)
            memo[name] = total
        return memo[name]

    return cost(entry)


B, S = 2, 32
KINDS = ("train", "prefill", "decode")
HLO_ARCHS = ("llama3-8b", "mamba2-370m", "granite-moe-3b-a800m")


@functools.lru_cache(maxsize=None)
def _flops(arch):
    """(reference HLO matmul FLOPs, the port's) by kind, float32 smoke."""
    ref_cfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                                  dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    shapes = {k: ShapeConfig(k, k, S, B) for k in KINDS}
    ref_shapes = {k: ref_base.ShapeConfig(k, k, S, B) for k in KINDS}
    pa, oa = ref_steps.abstract_state(ref_cfg, ref_base.TrainConfig())
    lowered = {
        "train": jax.jit(ref_steps.make_train_step(
            ref_cfg, ref_base.TrainConfig())).lower(
            pa, oa, ref_steps.input_specs(ref_cfg, ref_shapes["train"]),
            jax.ShapeDtypeStruct((), jnp.int32)),
        "prefill": jax.jit(ref_steps.make_prefill_step(ref_cfg)).lower(
            pa, ref_steps.input_specs(ref_cfg, ref_shapes["prefill"])),
        "decode": jax.jit(ref_steps.make_serve_step(ref_cfg)).lower(
            pa, ref_steps.abstract_cache(ref_cfg, ref_shapes["decode"]),
            ref_steps.input_specs(ref_cfg, ref_shapes["decode"])["token"]),
    }
    flash_cfg = dataclasses.replace(ref_cfg, flash=True)
    lowered["train-flash"] = jax.jit(ref_steps.make_train_step(
        flash_cfg, ref_base.TrainConfig())).lower(
        pa, oa, ref_steps.input_specs(flash_cfg, ref_shapes["train"]),
        jax.ShapeDtypeStruct((), jnp.int32))
    want = {k: _hlo_matmul_flops(v.compile().as_text())
            for k, v in lowered.items()}
    # FSDP storage over a counting group of 2 data ranks, each rank's
    # step on the whole batch here: FSDP moves state, not work
    data = sharding.ShardCtx(tp=2, rank=0, span=sharding.FSDP_SPAN,
                             group=sharding.CountingGroup(
                                 2, (0, 1), 0.0, sharding.CollectiveTally()))
    fsdp = {k: None if sp is None else (sp[0], data, None)
            for k, sp in sharding.fsdp_splits(cfg, {"data": 2}).items()}
    recs = {}
    for name, split in (("train", None), ("train-fsdp", fsdp)):
        params, opt = steps.abstract_state(cfg, TrainConfig(), fsdp=split)
        for p in _tree.leaves(params):
            p.requires_grad_(True)
        _, recs[name] = aot.count_step(
            steps.make_train_step(cfg, TrainConfig(), fsdp=split,
                                  dp_group=None if split is None
                                  else data.group), params, opt,
            aot._long(steps.input_specs(cfg, shapes["train"])), 0)
    served = aot.tf_params(cfg)
    with torch.no_grad():
        for name, split in (("prefill", None), ("prefill-fsdp", fsdp)):
            _, recs[name] = aot.count_step(
                steps.make_prefill_step(cfg, fsdp=split),
                steps.fsdp_blocks(served, split),
                aot._long(steps.input_specs(cfg, shapes["prefill"])))
        _, recs["decode"] = aot.count_step(
            steps.make_serve_step(cfg), served,
            steps.abstract_cache(cfg, shapes["decode"]),
            steps.input_specs(cfg, shapes["decode"])["token"].long())
    got = {}
    for k, rec in recs.items():
        # the kernels' matmuls over every (query, key) pair, as the
        # reference's dense attention multiplies them
        attn = 0.0
        for name, w in rec["kernels"].items():
            if name == "flash_attention":
                pairs = ops.attended_pairs(S, S, True, 0)
                attn += w["flops"] * S * S / pairs
            elif name == "decode_attention":
                attn += w["flops"]
        got[k] = rec["matmul_flops"] + attn
    return want, got


def _port_minus_reference(arch, kind) -> float:
    """The train step's matmul FLOPs the port counts and the reference's
    HLO does not (negative: the reverse), float32 smoke at B, S: per
    attention layer the backward's Q·Kᵀ over all S × T pairs; per SSM
    layer the two decay-gradient dots, each 2·B·S·nh·hd."""
    if kind != "train":
        return 0.0
    cfg = get_smoke_config(arch)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    attn = sum(k in ("global", "local") for k in kinds)
    ssm = kinds.count("ssm")
    nh = cfg.d_model * cfg.expand // cfg.ssm_head_dim
    return (attn * 2.0 * B * cfg.n_heads * S * S * cfg.head_dim
            - ssm * 2 * 2.0 * B * S * nh * cfg.ssm_head_dim)


@pytest.mark.parametrize("arch", HLO_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_matmul_flops_match_reference_hlo(arch, kind):
    want, got = _flops(arch)
    assert want[kind] > 0
    assert got[kind] == want[kind] + _port_minus_reference(arch, kind), (
        want, got)


@pytest.mark.parametrize("arch", HLO_ARCHS)
@pytest.mark.parametrize("kind", ("train-fsdp", "prefill-fsdp",
                                  "train-flash"))
def test_fsdp_and_flash_matmul_flops_match_reference_hlo(arch, kind):
    """The port's step with its params stored as FSDP blocks (gathered
    at entry, the gradient reduce-scattered) counts the matmul FLOPs of
    the step without FSDP: the reference's HLO exactly for the prefill,
    with the two traced differences for the train step.  The port's
    train step, which always runs the flash kernel, against the
    reference's ``flash=True`` train HLO: the same two differences (the
    reference's flash branch counts as its default one at these
    shapes)."""
    want, got = _flops(arch)
    base = kind.split("-")[0]
    ref = want[kind] if kind == "train-flash" else want[base]
    assert ref > 0
    assert got["train" if kind == "train-flash" else kind] == \
        ref + _port_minus_reference(arch, base), (want, got)


# ----------------------------------------------------------------------
# the kernels' meta route against chip_smoke.py's bounds
# ----------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_route_counts_equal_chip_smoke_bounds():
    """At phase 2's shapes: flash at the serve prompt and, with its
    log-sum-exp, at the training shape and gemma3's window; decode
    mid-generation at the serve shape and over a wrapped local ring;
    each combine at the hop's and the encode's shapes.  The wrappers
    compute nothing on meta and launch nothing."""
    cs = _chip_smoke()
    from repro_torch.models import attention as attn_lib

    before = ops.launch_counts()
    Bs, P, H, KV, DH = cs.B, cs.PROMPT, cs.H, cs.KV, cs.DH
    cases = []
    for S, window, lse in ((P, 0, False), (cs.TRAIN_SEQ, 0, True),
                           (2048, 1024, False)):
        ops.reset_meta_work()
        out = ops.flash_attention(_meta(Bs, S, H, DH), _meta(Bs, S, KV, DH),
                                  _meta(Bs, S, KV, DH), window=window,
                                  return_lse=lse)
        allowed = attn_lib._allowed(torch.arange(S), torch.arange(S), True,
                                    window)
        want = cs.flash_work(Bs, S, S, H, KV, DH, int(allowed.sum()),
                             with_lse=lse)
        w = ops.META_WORK["flash_attention"]
        cases.append(((w["bytes"], w["flops"]), want))
        assert (out[0] if lse else out).shape == (Bs, S, H, DH)
        assert w["scores"] == Bs * H * S * S
    for C, q_pos, window in ((P + cs.GEN + 1, P + cs.GEN // 2, 0),
                             (1024, 2047, 1024)):
        ops.reset_meta_work()
        ops.decode_attention(_meta(Bs, 1, H, DH), _meta(Bs, C, KV, DH),
                             _meta(Bs, C, KV, DH), q_pos, window=window)
        k_pos = attn_lib.ring_slot_positions(C, torch.tensor(q_pos + 1),
                                             window or C)
        ok = attn_lib._allowed(torch.tensor([q_pos]), k_pos, True, window)
        want = cs.decode_work(Bs, H, KV, DH, int(ok.sum()))
        w = ops.META_WORK["decode_attention"]
        cases.append(((w["bytes"], w["flops"]), want))
    block = cs.HOP_BLOCK
    for mode, fn, payload in (("int8", ops.combine_q, torch.int8),
                              ("int4", ops.combine_q4, torch.uint8),
                              ("fp8", ops.combine_f8,
                               torch.float8_e4m3fn)):
        K, F = 2, cs.EMBED_F
        cols = F // 2 if mode == "int4" else F
        ops.reset_meta_work()
        out = fn(_meta(1, K, dtype=torch.float32),
                 _meta(K, cols, dtype=payload),
                 _meta(K, F // block, dtype=torch.float32), block=block)
        assert out.shape == (1, F) and out.dtype == torch.float32
        (w,) = ops.META_WORK.values()
        cases.append(((w["bytes"], w["flops"]),
                      cs.combine_work(1, K, F, K * cols, K * F // block)))
    for R in (8, 1):
        ops.reset_meta_work()
        ops.combine(_meta(R, 8, dtype=torch.float32),
                    _meta(8, cs.WD_F, dtype=torch.float32))
        w = ops.META_WORK["coded_combine"]
        cases.append(((w["bytes"], w["flops"]),
                      cs.combine_work(R, 8, cs.WD_F, 8 * cs.WD_F * 4)))
    for got, want in cases:
        assert got == tuple(float(x) for x in want)
    assert ops.launch_counts() == before
