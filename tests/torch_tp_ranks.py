"""Rank bodies of the port's tensor-parallel tests (no jax here).

The tests run these in the ranks of ``repro_torch.dist.launch.run_ranks``
over gloo on the CPU; the spawned ranks import this module by name, so
it imports only the port, torch and numpy.  Each body returns host
values (numpy, floats), rank 0's full arrays where a test compares
parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.checkpoint.params import (
    _flatten,
    gather_params,
    leaf_keys,
    params_from_numpy,
    shard_array,
    shard_params,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import compression, grad_sync
from repro_torch.dist.mesh import DistMesh, OneCardMesh
from repro_torch.dist.sharding import (
    ShardCtx,
    model_ctx,
    param_axes,
    state_axis,
)
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer

DENSE = ("llama3-8b", "granite-8b", "starcoder2-3b", "gemma3-27b",
         "qwen2-vl-2b")
MODES = ("int8", "int4", "fp8")
LEAF_SHAPES = [(5, 7), (130,), (3,)]


def f32_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


# ----------------------------------------------------------------------
# the mesh's three calls
# ----------------------------------------------------------------------
def _group_fn(pod, data):
    rng = np.random.default_rng(100 * pod + data)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in LEAF_SHAPES]
    return grads, torch.tensor(float(rng.standard_normal()))


def _lam(pods, data):
    return np.arange(1, pods * data + 1, dtype=np.float32).reshape(
        pods, data) / 7.0


def mesh_decodes(mesh, residual_seed=3):
    """Every decode of ``mesh``: the f32 λ-weighted sum and each codec's
    hop (payloads decoded by the fused combine's plain version, EF rows
    updated) → host arrays."""
    lam = _lam(mesh.pods, mesh.data)
    out = {}
    g, loss = grad_sync.coded_weighted_psum(mesh, _group_fn, lam)
    out["f32"] = [x.numpy() for x in g] + [loss.numpy()]
    held = list(mesh.residual_rows())  # a pod rank holds its own row
    for mode in MODES:
        rng = np.random.default_rng(residual_seed)
        res = [torch.from_numpy(rng.standard_normal(
            (mesh.pods,) + s).astype(np.float32)[held] * 1e-2)
            for s in LEAF_SHAPES]
        g, loss = grad_sync.compressed_coded_psum(mesh, _group_fn, lam, res,
                                                  block=8, mode=mode)
        rows = [mesh.gather_pod_rows(r).numpy() for r in res]
        out[mode] = [x.numpy() for x in g] + [loss.numpy()] + rows
    return out


def one_card_decodes(pods, data):
    return mesh_decodes(OneCardMesh(pods, data))


def mesh_rank(pods, data, tp):
    """A rank of a (pod, data, model) world: the mesh's decodes, and with
    a "model" axis the ShardCtx collectives on known inputs."""
    mesh = DistMesh.for_world(pods, data, tp)
    out = {"decodes": mesh_decodes(mesh),
           "coords": (mesh.pod_rank, mesh.data_rank, mesh.model_rank)}
    ctx = mesh.ctx
    if ctx.active:
        r = ctx.axis_index()
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
        out["axis_index"] = r
        out["psum"] = ctx.psum(x).numpy()
        out["pmax"] = ctx.pmax(x - 10 * r).numpy()
        out["all_gather0"] = ctx.all_gather(x, axis=0).numpy()
        out["all_gather1"] = ctx.all_gather(x, axis=-1).numpy()
        # the gradients of psum and all_gather (JAX's transposes)
        xg = x.clone().requires_grad_(True)
        (ctx.psum(xg) * 2.0).sum().backward()
        out["psum_grad"] = xg.grad.numpy()
        xg = x.clone().requires_grad_(True)
        w = torch.arange(6 * ctx.tp, dtype=torch.float32).reshape(2, -1)
        (ctx.all_gather(xg, axis=-1) * w).sum().backward()
        out["gather_grad"] = xg.grad.numpy()
        # greedy over vocab-parallel logits: ties resolve to the lowest
        # global index, within a block and across blocks
        V = 4
        lg = torch.zeros(3, V)
        lg[0, 1] = lg[0, 3] = 5.0          # a tie inside every block
        lg[1, 2] = 7.0                     # a tie across every block
        lg[2, :] = -1.0
        if r == ctx.tp - 1:
            lg[2, 0] = 9.0                 # the max on the last rank only
        out["argmax"] = ctx.argmax(lg, V * ctx.tp).numpy()
        out["argmax_full"] = ctx.argmax(lg, V).numpy()
        out["sp"] = sp_helpers(ctx)
    return out


def sp_cotangent(shape, r):
    """Rank ``r``'s cotangent of an SP helper's output (the test rebuilds
    every rank's)."""
    return (np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            - 7.0) * (r + 2)


def sp_helpers(ctx, B=2, S=8, d=3):
    """The three sequence-parallel helpers on known inputs, a round trip,
    and each one's gradient under rank ``r``'s cotangent
    (:func:`sp_cotangent`)."""
    sp = dataclasses.replace(ctx, seq_shard=True)
    r, Sl = ctx.axis_index(), S // ctx.tp
    local = torch.arange(B * Sl * d, dtype=torch.float32).reshape(
        B, Sl, d) * (r + 1)
    full = torch.arange(B * S * d, dtype=torch.float32).reshape(B, S, d) \
        * (r + 1)
    out = {"gather": sp.gather_seq(local).numpy(),
           "scatter": sp.scatter_seq(full).numpy(),
           "psum_scatter": sp.psum_scatter(full).numpy(),
           "round_trip": sp.scatter_seq(sp.gather_seq(local)).numpy(),
           "off": [np.array_equal(f(full).numpy(), g.numpy()) for f, g in (
               (ctx.gather_seq, full), (ctx.scatter_seq, full),
               (ctx.psum_scatter, ctx.psum(full)))]}
    for name, fn, x in (("gather", sp.gather_seq, local),
                        ("scatter", sp.scatter_seq, full),
                        ("psum_scatter", sp.psum_scatter, full)):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        cot = torch.from_numpy(sp_cotangent(tuple(y.shape), r))
        (y * cot).sum().backward()
        out[name + "_grad"] = x.grad.numpy()
    try:
        sp.scatter_seq(torch.zeros(B, S + 1, d))
    except ValueError as e:
        out["bad_len"] = str(e)
    return out


ARCHS = DENSE + ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                 "mamba2-370m", "recurrentgemma-2b", "whisper-medium")


def shard_round_trip(tp):
    """shard_params → gather_params for every config (the 3-D expert
    leaves split on axis −3, the conv and SSM-head leaves on −1), and
    ``init_params(tp=tp, rank=r)`` against the slice of tp 1."""
    ctx = model_ctx(tp)
    r = dist.get_rank()
    bad = []
    for arch in ARCHS:
        cfg = f32_cfg(arch)
        full = tf.init_params(cfg, torch.Generator().manual_seed(5),
                              device="cpu", dtype=torch.float32)
        flat = {k: v.numpy() for k, v in _flatten(full).items()}
        local = shard_params(flat, cfg, tp, r)
        back = gather_params({k: torch.from_numpy(v)
                              for k, v in local.items()}, cfg, ctx)
        for k, v in flat.items():
            if not np.array_equal(back[k], v):
                bad.append((arch, "round trip", k))
        mine = tf.init_params(cfg, torch.Generator().manual_seed(5),
                              device="cpu", dtype=torch.float32, tp=tp,
                              rank=r)
        for k, v in _flatten(mine).items():
            if not np.array_equal(v.numpy(), local[k]):
                bad.append((arch, "init slice", k))
        axes = param_axes(cfg, tp)
        if not any(ax is not None for ax in axes.values()):
            bad.append((arch, "nothing sharded"))
        # optimizer state: each leaf's slice is the state of the slices
        for name in ("adamw", "adafactor", "momentum"):
            opt = make_optimizer(name)
            whole = _flatten(opt.init(full))
            local_st = _flatten(opt.init(mine))
            g = torch.Generator().manual_seed(9)
            whole = {k: torch.rand(v.shape, generator=g)
                     for k, v in whole.items()}
            st_axes = {k: state_axis(k, axes) for k in whole}
            for k, v in whole.items():
                part = shard_array(v, st_axes[k], tp, r)
                if part.shape != local_st[k].shape:
                    bad.append((arch, name, k, "shape"))
            back = gather_params({k: shard_array(v, st_axes[k], tp, r)
                                  for k, v in whole.items()}, cfg, ctx,
                                 st_axes)
            for k, v in whole.items():
                if not np.array_equal(back[k], v.numpy()):
                    bad.append((arch, name, k, "round trip"))
    return bad


#: the optimizer's reductions on slices: the dense leaves, the 3-D
#: expert leaves (split on axis −3), the SSD's conv and head leaves, the
#: RG-LRU's row-parallel gates and conv
OPT_ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "mamba2-370m",
             "recurrentgemma-2b")


def optimizer_reductions(tp, arch="llama3-8b"):
    """The optimizer on a rank's slices against the same on the full
    leaves: the global norm, a clip and one adafactor and one adamw
    update of ``arch``'s smoke params under random gradients → the
    largest differences (gathered)."""
    from repro_torch.optim import clip_by_global_norm_, global_norm

    ctx = model_ctx(tp)
    r = dist.get_rank()
    cfg = f32_cfg(arch)
    axes = param_axes(cfg, tp)
    g = torch.Generator().manual_seed(3)
    full = tf.init_params(cfg, g, device="cpu", dtype=torch.float32)
    keys = leaf_keys(full)
    grads = [torch.randn(p.shape, generator=g) for p in _tree.leaves(full)]
    ax = [axes[k] for k in keys]
    mine = [shard_array(x, a, tp, r) for x, a in zip(grads, ax)]
    out = {"norm": abs(float(global_norm(mine, ctx, ax))
                       - float(global_norm(grads)))
           / float(global_norm(grads))}
    clipped = [x.clone() for x in grads]
    clip_by_global_norm_(clipped, 1.0)
    clip_by_global_norm_(mine, 1.0, ctx, ax)
    out["clip"] = max(float((shard_array(c, a, tp, r) - m).abs().max())
                      for c, m, a in zip(clipped, mine, ax))
    for name in ("adafactor", "adamw"):
        opt = make_optimizer(name)
        p_full = _tree.map(lambda t: t.clone(), full)
        p_mine = _tree.map(lambda t: t, params_from_numpy(shard_params(
            {k: v.numpy() for k, v in _flatten(full).items()}, cfg, tp, r),
            "cpu"))
        st_full, st_mine = opt.init(p_full), opt.init(p_mine)
        lr = torch.tensor(0.1)
        opt.apply_([x.clone() for x in clipped], st_full, p_full, lr)
        opt.apply_([shard_array(x, a, tp, r) for x, a in
                    zip(clipped, ax)], st_mine, p_mine, lr, ctx=ctx,
                   axes=ax)
        back = gather_params(_flatten(p_mine), cfg, ctx, axes)
        out[name] = max(float(np.abs(back[k] - v.numpy()).max())
                        for k, v in _flatten(p_full).items())
    return out


def divide(n):
    """Rank 1 divides by ``n``; rank 0 waits for it in a barrier."""
    if dist.get_rank() == 1:
        return 1 / n
    dist.barrier()


def mesh_world(pods, data, tp):
    out = mesh_rank(pods, data, tp)
    if tp > 1 and dist.get_world_size() == tp:
        out["round_trip"] = shard_round_trip(tp)
        out["optimizer"] = {a: optimizer_reductions(tp, a)
                            for a in OPT_ARCHS}
    return out


# ----------------------------------------------------------------------
# the dist train step against a single-device step
# ----------------------------------------------------------------------
def train_cases(cases):
    """Each case: one step of the port's dist train step on this world
    (``pp`` stages when the case says so; the params and the optimizer
    state FSDP blocks where the data ranks are ranks of their own, as
    ``TrainConfig.fsdp`` says by default) → rank 0's (loss, grad_norm,
    full params by flat key)."""
    from repro_torch.dist.sharding import NULL_CTX

    out = []
    for c in cases:
        cfg = dataclasses.replace(f32_cfg(c["arch"]), **c.get("changes", {}))
        tp, pp = c["tp"], c.get("pp", 1)
        mesh = DistMesh.for_world(c["pods"], c["data"], tp, pp=pp)
        tcfg = TrainConfig(**c["tcfg"])
        data = mesh.data_ctx if tcfg.fsdp else NULL_CTX
        mine = shard_params(c["params"], cfg, tp, mesh.model_rank, pp=pp,
                            stage=mesh.stage)
        residual = (_tree.leaves(compression.init_pod_residuals(
            params_from_numpy(mine, "cpu"), len(mesh.residual_rows())))
            if tcfg.grad_compression != "none" else [])
        params = params_from_numpy(
            shard_params(mine, cfg, 1, 0, {}, data=data.tp,
                         data_rank=data.rank), "cpu")
        for p in _tree.leaves(params):
            p.requires_grad_(True)
        step = steps._make_dist_train_step(cfg, tcfg, mesh)
        state = step.optimizer.init(params)
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 c["batch"].items()}
        batch["tokens"] = batch["tokens"].long()
        batch["targets"] = batch["targets"].long()
        lam = np.full((c["pods"], c["data"]),
                      1.0 / (c["pods"] * c["data"]), np.float32)
        params, state, residual, m = step(params, state, batch, lam,
                                          residual, 0)
        full = gather_params(_flatten(params), cfg, mesh.ctx,
                             stage=mesh.stage_ctx, data=data)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": full} if dist.get_rank() == 0 else None)
    return out


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def serve_cases(cases, tp):
    """Each case: the reference-initialized weights (full flat arrays),
    a prompt → this rank's greedy tokens at tp, the prefill's gathered
    logits, and rank 0's serve CLI result."""
    from repro_torch.api import serving

    ctx = model_ctx(tp)
    out = []
    for c in cases:
        cfg = f32_cfg(c["arch"])
        params = params_from_numpy(
            shard_params(c["params"], cfg, tp, ctx.rank), "cpu")
        frames = c.get("enc_frames")
        toks = serving.generate(params, cfg, c["prompt"], c["gen"],
                                max_len=c["max_len"], enc_frames=frames,
                                exact_handoff=c["exact"], device="cpu",
                                ctx=ctx)
        with torch.no_grad():
            logits, _ = tf.forward(
                params, cfg, torch.from_numpy(c["prompt"]).long(),
                enc_frames=None if frames is None
                else torch.from_numpy(frames), ctx=ctx)
        if logits.shape[-1] != cfg.vocab:
            logits = ctx.all_gather(logits, -1)
        out.append({"tokens": toks, "logits": logits.numpy()})
    return out


def archs_at_tp(archs, tp):
    """Each smoke config at ``tp`` in this world → this rank's checks:
    ``init_params`` gives the slices of the tp-1 shapes, ``init_cache``
    builds, a coded session builds (and, but for whisper, whose coded
    batches carry no frames, takes a step), and the serve CLI at ``--tp``
    serves (joining this world) → its tokens."""
    from repro_torch.api import CodedCluster, CodedSession
    from repro_torch.launch import serve

    r = dist.get_rank()
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        axes = param_axes(cfg, tp)
        full = _flatten(tf.init_params(cfg, device="meta"))
        mine = _flatten(tf.init_params(cfg, device="cpu", tp=tp, rank=r))
        bad = [k for k, v in full.items() if tuple(mine[k].shape) !=
               tuple(shard_array(torch.empty(v.shape, device="meta"),
                                 axes[k], tp, r).shape)]
        tf.init_cache(cfg, 1, 8, device="cpu", tp=tp)
        s = CodedSession(CodedCluster.homogeneous(2, 4), cfg, mode="coded",
                         tp=tp, seq_len=16, total_steps=1, device="cpu",
                         verbose=False)
        losses = [] if cfg.is_encdec else list(s.fit(1)["losses"])
        res = serve.main(["--arch", arch, "--device", "cpu", "--tp",
                          str(tp), "--gen", "4"])
        out[arch] = dict(bad_shapes=bad, split=sum(
            ax is not None for ax in axes.values()), losses=losses,
            tokens=np.asarray(res["tokens"]))
    return out


# ----------------------------------------------------------------------
# sessions
# ----------------------------------------------------------------------
def session_run(kw, fit_kw, ckpt_step=0, with_state=False):
    """A coded session in this world → rank 0's losses, grad norms and
    full params (after a checkpoint at ``ckpt_step`` when it is set;
    ``with_state``: also the full params before the first step and the
    EF residual rows at the end, gathered as a checkpoint gathers them)."""
    from repro_torch.api import CodedCluster, CodedSession

    cl = kw.pop("cluster")
    cluster = (CodedCluster.hetero if cl[0] == "hetero"
               else CodedCluster.homogeneous)(cl[1], cl[2])
    s = CodedSession(cluster, f32_cfg(kw.pop("arch")), device="cpu",
                     verbose=False, **kw)
    # a copy: at one rank the host arrays would share the live params
    start = ({k: np.array(v) for k, v in s.full_params().items()}
             if with_state else None)
    s.fit(**fit_kw)
    if ckpt_step:
        s.save_checkpoint(ckpt_step)
    full = s.full_params()
    residual = None
    if with_state:
        residual = s._gather({k: s._mesh.gather_pod_rows(r) for k, r in
                              zip(leaf_keys(s.params), s.residual)},
                             "residual")
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    out = {"losses": list(s.losses), "params": full}
    if with_state:
        out.update(start=start, residual=residual)
    return out


def shrink_run(kw):
    """A coded_int8 session on hetero(3, 2) in this world (or in this
    process): 3 steps, edge 1 shrunk away, 3 more → rank 0's losses,
    full params before the first step and at the end, and the first EF
    residual's gathered rows before and after the shrink."""
    from repro_torch.api import CodedCluster, CodedSession

    s = CodedSession(CodedCluster.hetero(3, 2), f32_cfg("llama3-8b"),
                     planner="fixed", mode="coded_int8", device="cpu",
                     verbose=False, **kw)
    start = {k: np.array(v) for k, v in s.full_params().items()}
    key = leaf_keys(s.params)[0]
    ctx = s._ctx

    def rows():
        # a copy: at tp 1 the host array would share the live residual
        return np.array(gather_params({key: s.residual[0]}, s.cfg, ctx,
                                      {key: s._axes[key]})[key])

    s.fit(3)
    before = rows()
    s.shrink(dead_edges=[1])
    after = rows()
    s.fit(6)
    full = s.full_params()
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {"losses": list(s.losses), "start": start, "params": full,
            "before": before, "after": after, "pods": s.cluster.topo.n}



# ----------------------------------------------------------------------
# pipeline parallelism: the "stage" axis
# ----------------------------------------------------------------------
def _stage_slices(flat, cfg, tp, pp, mesh, axes=None, st_axes=None):
    return shard_params(flat, cfg, tp, mesh.model_rank, axes, pp=pp,
                        stage=mesh.stage, stage_axes=st_axes)


def pp_mesh_world(pods, data, tp, pp):
    """A rank of a (stage, pod, data, model) world: the mesh's decodes,
    its coordinates, the stage handoff both ways in every dtype the
    pipeline carries (and fp8 as bytes), the stage sum, and for the
    configs' params and optimizer states the shard → gather round trip
    and the optimizer's reductions over both axes."""
    from repro_torch.optim import clip_by_global_norm_, global_norm
    from repro_torch.dist.sharding import stage_axes

    mesh = DistMesh.for_world(pods, data, tp, pp=pp)
    out = {"decodes": mesh_decodes(mesh),
           "coords": (mesh.stage, mesh.pod_rank, mesh.data_rank,
                      mesh.model_rank)}
    st = mesh.stage
    hand = {}
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        x = (torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
             + 100 * st + 10 * mesh.global_rank).to(dt)
        got = {}
        if st + 1 < pp:
            mesh.send_next(x)
        if st > 0:
            got["fwd"] = mesh.recv_prev(torch.empty_like(x)).float().numpy()
            mesh.send_prev(x)
        if st + 1 < pp:
            got["bwd"] = mesh.recv_next(torch.empty_like(x)).float().numpy()
        hand[str(dt)] = got
    out["handoff"] = hand
    out["stage_sum"] = mesh.stage_ctx.reduce_sum(
        torch.tensor([1.0, float(st)])).numpy()
    bad = []
    norms = {}
    for arch in ("llama3-8b", "gemma3-27b", "mamba2-370m",
                 "recurrentgemma-2b", "whisper-medium"):
        cfg = f32_cfg(arch)
        layers = {"gemma3-27b": 12, "recurrentgemma-2b": 6}.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        g = torch.Generator().manual_seed(3)
        full = tf.init_params(cfg, g, device="cpu", dtype=torch.float32)
        flat = {k: v.numpy() for k, v in _flatten(full).items()}
        mine = _stage_slices(flat, cfg, tp, pp, mesh)
        drawn = _flatten(tf.init_params(
            cfg, torch.Generator().manual_seed(3), device="cpu",
            dtype=torch.float32, tp=tp, rank=mesh.model_rank, pp=pp,
            stage=st))
        for k, v in drawn.items():
            if not np.array_equal(v.numpy(), mine[k]):
                bad.append((arch, "init slice", k))
        back = gather_params({k: torch.from_numpy(v) for k, v in
                              mine.items()}, cfg, mesh.ctx,
                             stage=mesh.stage_ctx)
        bad += [(arch, "round trip", k) for k, v in flat.items()
                if not np.array_equal(back[k], v)]
        axes = param_axes(cfg, tp)
        st_axes = stage_axes(cfg, pp)
        keys = leaf_keys(full)
        grads = [torch.randn(p.shape, generator=g) for p in
                 _tree.leaves(full)]
        ax = [axes[k] for k in keys]
        sx = [st_axes[k] for k in keys]
        part = [shard_array(shard_array(x, a, tp, mesh.model_rank), b, pp,
                            st) for x, a, b in zip(grads, ax, sx)]
        split = dict(ctx=mesh.ctx, axes=ax, stage=mesh.stage_ctx,
                     stage_axes=sx)
        res = {"norm": abs(float(global_norm(part, **split))
                           - float(global_norm(grads)))
               / float(global_norm(grads))}
        clipped = [x.clone() for x in grads]
        clip_by_global_norm_(clipped, 1.0)
        clip_by_global_norm_(part, 1.0, **split)
        res["clip"] = max(float((shard_array(shard_array(
            c, a, tp, mesh.model_rank), b, pp, st) - m).abs().max())
            for c, m, a, b in zip(clipped, part, ax, sx))
        for name in ("adafactor", "adamw"):
            opt = make_optimizer(name)
            p_full = _tree.map(lambda t: t.clone(), full)
            p_mine = params_from_numpy(mine, "cpu")
            st_full, st_mine = opt.init(p_full), opt.init(p_mine)
            lr = torch.tensor(0.1)
            opt.apply_([x.clone() for x in clipped], st_full, p_full, lr)
            opt.apply_([x.clone() for x in part], st_mine, p_mine, lr,
                       **split)
            back = gather_params(_flatten(p_mine), cfg, mesh.ctx,
                                 stage=mesh.stage_ctx)
            res[name] = max(float(np.abs(back[k] - v.numpy()).max())
                            for k, v in _flatten(p_full).items())
            # the state's slices gather back to the whole state
            flat_st = _flatten(st_mine)
            whole = gather_params(
                flat_st, cfg, mesh.ctx,
                {k: state_axis(k, axes) for k in flat_st}, mesh.stage_ctx,
                {k: state_axis(k, st_axes) for k in flat_st})
            res[name + "_state"] = max(
                float(np.abs(whole[k] - v.numpy()).max())
                for k, v in _flatten(st_full).items())
        norms[arch] = res
    out["round_trip"] = bad
    out["optimizer"] = norms
    return out


def pp_checkpoint_run(kw, fit_kw, ckpt_dir, resume):
    """A coded session in this world (or this process) with checkpoints
    in ``ckpt_dir``: resumed from its latest checkpoint (``resume``),
    else trained by ``fit_kw`` with the checkpoints ``kw`` asks for →
    rank 0's losses, full params and full optimizer state (gathered over
    "model" and "stage")."""
    from repro_torch.api import CodedCluster, CodedSession

    kw = dict(kw)
    cl = kw.pop("cluster")
    cluster = (CodedCluster.hetero if cl[0] == "hetero"
               else CodedCluster.homogeneous)(cl[1], cl[2])
    s = CodedSession(cluster, f32_cfg(kw.pop("arch")), device="cpu",
                     verbose=False, checkpoint_dir=ckpt_dir, resume=resume,
                     **kw)
    if not resume:
        s.fit(**fit_kw)
    out = {"losses": list(s.losses), "step": s._step,
           "params": s.full_params(),
           "opt_state": s._gather(_flatten(s.opt_state), "state")}
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return out


def pp_kill_resume(kw, ckpt_dir, steps, stop):
    """Kill/resume in this world: an uninterrupted run of ``steps``
    steps, then a run killed after ``stop`` (``kw``'s checkpoint period
    puts a checkpoint there) and a
    fresh session resumed from it → rank 0's (uninterrupted losses,
    killed losses, resumed losses, both runs' final params)."""
    from repro_torch.api import CodedCluster, CodedSession

    def session(**extra):
        k = dict(kw)
        cl = k.pop("cluster")
        cluster = (CodedCluster.hetero if cl[0] == "hetero"
                   else CodedCluster.homogeneous)(cl[1], cl[2])
        return CodedSession(cluster, f32_cfg(k.pop("arch")), device="cpu",
                            verbose=False, **k, **extra)

    whole = session()
    whole.fit(steps)
    killed = session(checkpoint_dir=ckpt_dir)
    killed.fit(steps, stop_after=stop)
    resumed = session(checkpoint_dir=ckpt_dir, resume=True)
    resumed.fit(steps)
    out = {"whole": list(whole.losses), "killed": list(killed.losses),
           "resumed": list(resumed.losses), "start": resumed._step - len(
               resumed.losses),
           "params": [whole.full_params(), resumed.full_params()]}
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return out


def eval_generate_run(kw, batch, prompts, gen):
    """A coded session in this world (or this process), untrained: its
    ``eval_step`` on ``batch`` and ``generate``'s greedy tokens (under PP
    both gather the whole model first) → rank 0's."""
    from repro_torch.api import CodedCluster, CodedSession

    kw = dict(kw)
    cl = kw.pop("cluster")
    cluster = (CodedCluster.hetero if cl[0] == "hetero"
               else CodedCluster.homogeneous)(cl[1], cl[2])
    s = CodedSession(cluster, f32_cfg(kw.pop("arch")), device="cpu",
                     verbose=False, **kw)
    out = {"eval": s.eval_step(batch), "tokens": s.generate(prompts, gen)}
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return out


# ----------------------------------------------------------------------
# shrink where pods and workers are ranks of their own
# ----------------------------------------------------------------------
def _gathered_rows(s):
    """The first EF residual leaf with every pod's row current, full over
    "model" (collective over the mesh)."""
    key = leaf_keys(s.params)[0]
    rows = s._mesh.gather_pod_rows(s.residual[0])
    return np.array(gather_params({key: rows}, s.cfg, s._ctx,
                                  {key: s._axes[key]})[key])


def shrink_ranks_run(kw, dead_edges=(1,), ck_dir="", params=None,
                     probe_uneven=False):
    """A coded_int8 session on hetero(3, 2) in this world: 3 steps,
    ``dead_edges`` shrunk away (after a refused uneven shrink of worker
    (0, 1), with ``probe_uneven``), a checkpoint into ``ck_dir`` if
    given, 3 more steps → this rank's record: whether it retired (then
    the message its next step raised), else the losses, the first
    residual leaf's gathered rows before and after the shrink and the
    full params at the end."""
    from repro_torch.api import CodedCluster, CodedSession

    s = CodedSession(CodedCluster.hetero(3, 2), f32_cfg("llama3-8b"),
                     planner="fixed", mode="coded_int8", device="cpu",
                     verbose=False, checkpoint_dir=ck_dir, params=params,
                     **kw)
    layout = (s._mesh.pod_ranks, s._mesh.data_ranks, s._mesh.tp)
    s.fit(3)
    out = {"rank": dist.get_rank(), "layout": layout,
           "before": _gathered_rows(s)}
    if probe_uneven:
        try:
            s.shrink(dead_workers=[(0, 1)])
        except ValueError as err:
            out["uneven"] = (str(err), s.cluster.topo.m, s.code.topo.m)
    plan = s.shrink(dead_edges=list(dead_edges))
    out["plan_m"] = plan.code.topo.m
    out["retired"] = s._retired
    if s._retired:
        try:
            s.step()
        except RuntimeError as err:
            out["error"] = str(err)
        return out
    out["after"] = _gathered_rows(s)
    out["mesh"] = (s._mesh.ranks, s._mesh.pod_rank, s._mesh.data_rank)
    if ck_dir:
        out["ck_path"] = s.save_checkpoint()
    s.fit(6)
    out["losses"] = list(s.losses)
    out["params"] = s.full_params()
    return out


def resume_ranks_run(kw, ck_dir):
    """A fresh session on the unshrunk hetero(3, 2) cluster that resumes
    ``ck_dir`` in this (smaller) world and steps to 6 → its losses, the
    topology it restored, the layout it runs and the full params."""
    from repro_torch.api import CodedCluster, CodedSession

    s = CodedSession(CodedCluster.hetero(3, 2), f32_cfg("llama3-8b"),
                     planner="fixed", mode="coded_int8", device="cpu",
                     verbose=False, checkpoint_dir=ck_dir, resume=True,
                     **kw)
    start = s._step
    s.fit(6)
    return {"start": start, "losses": list(s.losses),
            "m": s.cluster.topo.m, "dead_edges": s.cluster.dead_edges,
            "layout": (s._mesh.pod_ranks, s._mesh.data_ranks, s._mesh.tp),
            "params": s.full_params()}


# ----------------------------------------------------------------------
# the collectives of one step, tallied
# ----------------------------------------------------------------------
TALLY_B, TALLY_S, TALLY_GEN = 2, 16, 2


def tally_steps(ctx, device):
    """The llama3-8b float32 smoke config at ``ctx``'s degree on
    ``device`` (``meta``: shapes only): a train step (sgd), the same with
    sequence parallelism, and with the ``save_block_outputs`` remat; FSDP
    steps over the same ranks as data ranks (no TP: one reduce-scatter
    of the whole batch's gradient, and with ``sharded_accum`` one a
    microbatch); and a served request (bulk prefill and ``TALLY_GEN``
    greedy tokens) → name → a function that runs it."""
    from repro_torch.api import serving
    from repro_torch.dist.sharding import FSDP_SPAN, NULL_CTX, fsdp_splits

    cfg = f32_cfg("llama3-8b")
    tcfg = TrainConfig(optimizer="sgd", lr=0.05, warmup_steps=0)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, gen, device=device, dtype=torch.float32,
                            tp=ctx.tp, rank=ctx.rank)
    whole = tf.init_params(cfg, gen, device=device, dtype=torch.float32)
    dp = dist.group.WORLD if ctx.group is None else ctx.group
    data = ShardCtx(tp=ctx.tp, rank=ctx.rank, group=dp, span=FSDP_SPAN)
    fsdp = {k: None if sp is None else (sp[0], data, None)
            for k, sp in fsdp_splits(cfg, {"data": ctx.tp}).items()}
    rng = np.random.default_rng(1)
    shape = (TALLY_B, TALLY_S)

    def ids():
        t = torch.from_numpy(rng.integers(0, cfg.vocab, shape))
        return t.to(device)

    batch = {"tokens": ids(), "targets": ids(),
             "weights": torch.ones(shape, device=device)}

    def train(sp, policy="full"):
        def run():
            c = dataclasses.replace(ctx, seq_shard=sp)
            for p in _tree.leaves(params):
                p.requires_grad_(True)
            step = steps.make_train_step(
                dataclasses.replace(cfg, remat_policy=policy), tcfg, ctx=c)
            step(params, step.optimizer.init(params), batch, 0)
        return run

    def train_fsdp(accum):
        def run():
            blocks = steps.fsdp_blocks(whole, fsdp)
            for p in _tree.leaves(blocks):
                p.requires_grad_(True)
            step = steps.make_train_step(
                cfg, dataclasses.replace(tcfg, microbatch=accum), ctx=NULL_CTX,
                dp_group=dp, fsdp=fsdp, sharded_accum=bool(accum))
            step(blocks, step.optimizer.init(blocks), batch, 0)
        return run

    def serve():
        with torch.no_grad():
            max_len = TALLY_S + TALLY_GEN + 1
            serving.token_loop(
                params, cfg, batch["tokens"], TALLY_GEN,
                prefill_fn=serving.make_prefill_fn(cfg, max_len, ctx=ctx),
                decode_fn=serving.make_decode_fn(cfg, ctx=ctx), ctx=ctx)

    return {"train": train(False), "train-sp": train(True),
            "train-sbo": train(False, "save_block_outputs"),
            "train-fsdp": train_fsdp(0), "train-fsdp-accum": train_fsdp(1),
            "serve": serve}


def block_outputs_grads(ctx):
    """The loss and this rank's gradients of the llama3-8b float32 smoke
    config at ``ctx``'s degree under remat ``full`` and
    ``save_block_outputs`` → policy → (loss, gradient leaves)."""
    cfg = f32_cfg("llama3-8b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32, tp=ctx.tp,
                            rank=ctx.rank)
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    shape = (TALLY_B, TALLY_S)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape)),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab, shape)),
             "weights": torch.ones(shape)}
    out = {}
    for policy in ("full", "save_block_outputs"):
        g, m = steps._grads(params, dataclasses.replace(
            cfg, remat_policy=policy), batch, ctx=ctx)
        out[policy] = (float(m["loss"]), [x.numpy() for x in g])
    return out


def tally_run():
    """Each of :func:`tally_steps` in this world's model axis, its
    collectives recorded in ``sharding.TALLY`` → name → per kind
    (count, operand bytes, link bytes)."""
    from repro_torch.dist import sharding

    out = {}
    for name, run in tally_steps(model_ctx(dist.get_world_size()),
                                 "cpu").items():
        sharding.TALLY = sharding.CollectiveTally()
        run()
        out[name] = {k: (v["count"], v["operand_bytes"], v["link_bytes"])
                     for k, v in sharding.TALLY.by_kind.items()}
        sharding.TALLY = None
    out["grads"] = block_outputs_grads(model_ctx(dist.get_world_size()))
    return out


# ----------------------------------------------------------------------
# make_train_step's tensor- and data-parallel step (the dry run's)
# ----------------------------------------------------------------------
#: case → (data-parallel ranks, sequence parallelism, FSDP over the data
#: ranks, microbatch with ``sharded_accum``); "model" is 2 ranks
DP_CASES = {"tp2": (1, False, False, 0), "tp2-sp": (1, True, False, 0),
            "tp2dp2": (2, False, False, 0),
            "tp2dp2-fsdp": (2, False, True, 0),
            "tp2dp2-fsdp-accum": (2, False, True, 1)}
#: no clipping: a clipped step would hide a gradient off by a factor
DP_TCFG = TrainConfig(optimizer="sgd", lr=0.05, warmup_steps=0,
                      grad_clip=0.0)


def dp_train_run(flat, batch):
    """One sgd step of ``launch.steps.make_train_step`` per case of
    :data:`DP_CASES` in a world of 4 ranks, rank 2·d + m at data index d
    and model index m: the llama3-8b float32 smoke config's slices of
    ``flat`` under a "model" ctx of 2; at 2 data ranks each takes its
    half of ``batch``'s rows and the step averages over the data group →
    case → rank 0's (loss, gathered params)."""
    cfg = f32_cfg("llama3-8b")
    r = dist.get_rank()
    d, m = divmod(r, 2)
    model_groups = [dist.new_group([2 * i, 2 * i + 1]) for i in range(2)]
    data_groups = [dist.new_group([j, 2 + j]) for j in range(2)]
    from repro_torch.dist.sharding import FSDP_SPAN, NULL_CTX, data_axes

    out = {}
    for name, (dp, sp, fsdp, accum) in DP_CASES.items():
        ctx = ShardCtx(tp=2, rank=m, group=model_groups[d], seq_shard=sp)
        data = ShardCtx(tp=2, rank=d, group=data_groups[m],
                        span=FSDP_SPAN) if fsdp else NULL_CTX
        split = {k: None if ax is None else (ax, data, None)
                 for k, ax in data_axes(cfg, 2).items()} if fsdp else None
        params = params_from_numpy(shard_params(
            flat, cfg, 2, m, data=data.tp, data_rank=data.rank), "cpu")
        for p in _tree.leaves(params):
            p.requires_grad_(True)
        n = len(batch["tokens"]) // dp
        rows = slice(d * n, (d + 1) * n) if dp > 1 else slice(None)
        local = {k: torch.from_numpy(np.asarray(v)[rows])
                 for k, v in batch.items()}
        local["tokens"], local["targets"] = (local["tokens"].long(),
                                             local["targets"].long())
        step = steps.make_train_step(
            cfg, dataclasses.replace(DP_TCFG, microbatch=accum), ctx=ctx,
            dp_group=data_groups[m] if dp > 1 else None, fsdp=split,
            sharded_accum=bool(accum))
        params, _, metrics = step(params, step.optimizer.init(params),
                                  local, 0)
        full = gather_params(_flatten(params), cfg, ctx, data=data)
        out[name] = ({"loss": float(metrics["loss"]), "params": full}
                     if r == 0 else None)
    return out
