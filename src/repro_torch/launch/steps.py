"""Train-step builders of the port.

PyTorch counterpart of ``repro.launch.steps``:

  * :func:`make_train_step` — the single-host step (mode ``off``):
    microbatched gradient accumulation, global-norm clipping, the cosine
    LR schedule and the optimizer update (one data-parallel rank's, with
    its "model" slices under a ``ctx`` and its FSDP blocks under
    ``fsdp``: the dry run's step).  The HGC
    hook rides the batch: per-example coded weights (coeff × λ) in
    ``batch["weights"]`` and the fixed ``batch["denom"]`` make the
    gradient the decoded aggregate.
  * :func:`_make_dist_train_step` — the coded step (modes ``coded``,
    ``coded_int8``, ``coded_q``) on the (pod, data) mesh — on one card
    (``OneCardMesh``) or over ranks with tensor parallelism
    (``DistMesh``): each
    group's gradient of its own coeff-weighted loss IS its message G_ij
    (eq. 22; under FSDP from the whole leaves gathered at entry),
    decoded by the two-stage λ-weighted sum of
    :mod:`repro_torch.dist.grad_sync` (eqs. 25/27), with the quantized +
    error-feedback hop when ``tcfg.grad_compression`` is set.  For MoE
    archs λ is folded into each group's objective and the load-balancing
    aux gradient decoded with uniform weights (the reference's rule).
    On a ``DistMesh`` with a "stage" axis the coded step runs pipeline
    parallelism (:func:`_pipeline_grads`).
  * :func:`make_serve_step` and :func:`make_prefill_step` (one decode
    step, the prefill), and the dry run's inputs on the ``meta`` device:
    :func:`input_specs`, :func:`abstract_state` (with :func:`fsdp_blocks`),
    :func:`abstract_cache`.

Steps update the params and the optimizer state in place and return
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import _tree, obs
from repro_torch.checkpoint.params import leaf_keys
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.dist.sharding import (
    NULL_CTX,
    ShardCtx,
    all_reduce,
    data_axes,
    fsdp_block,
    fsdp_gather,
    group_size,
    model_sharded_mask,
    param_axes,
    reduce_scatter,
    seq_sharded_mask,
    stage_axes,
    stage_sharded_mask,
    validate_pp,
)
from repro_torch.models import transformer as tf
from repro_torch.optim import (
    clip_by_global_norm_,
    cosine_schedule,
    global_norm,
    make_optimizer,
)

PyTree = Any

# per-arch optimizer defaults for the production configs (the reference's)
ARCH_OPTIMIZER = {
    "llama4-maverick-400b-a17b": "adafactor",
    "gemma3-27b": "adafactor",
}


def default_optimizer_name(cfg: ModelConfig, tcfg: TrainConfig) -> str:
    return ARCH_OPTIMIZER.get(cfg.name, tcfg.optimizer)


def _batch_rows(batch: Dict[str, torch.Tensor], B: int, rows: slice
               ) -> Dict[str, torch.Tensor]:
    """The rows ``rows`` of a ``B``-row batch: every tensor's batch axis
    is 0 but for M-RoPE ``positions`` (3, B, S), whose batch axis is 1
    (as the reference splits them); tensors without a ``B``-row batch
    axis (the scalar ``denom``) pass whole."""
    out = {}
    for k, v in batch.items():
        if k == "positions" and v.ndim == 3 and v.shape[1] == B:
            out[k] = v[:, rows]
        elif v.ndim and v.shape[0] == B:
            out[k] = v[rows]
        else:
            out[k] = v
    return out


def _grads(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           objective: Optional[Callable] = None, ctx: ShardCtx = NULL_CTX):
    """(gradient leaves in leaf order, metrics) of ``loss_and_metrics``'s
    total, or of ``objective(metrics)`` when given.  A leaf the loss
    does not reach (whisper's encoder layers carry a cross-attention
    they never run, as the reference's do) gets zeros, as ``jax.grad``
    gives it."""
    leaves = _tree.leaves(params)
    with torch.enable_grad():
        with obs.span("model.forward"):
            total, metrics = tf.loss_and_metrics(params, cfg, batch, ctx=ctx)
            if objective is not None:
                total = objective(metrics)
        with obs.span("model.backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _finish(params, opt_state, grads, optimizer, tcfg, lr_at, step,
            metrics, ctx: ShardCtx = NULL_CTX, axes=None,
            stage: ShardCtx = NULL_CTX, st_axes=None, data=None,
            whole: bool = False):
    """Clip, schedule and apply the update in place; the shared tail of
    both steps (under TP each rank's slices, the norm and adafactor's
    statistics reduced over "model": ``ctx``, ``axes``; under PP over
    "stage" too: ``stage``, ``st_axes``).  Under FSDP ``data`` gives each
    leaf's ``(axis, context)`` (None: whole) and ``params`` and
    ``opt_state`` are this rank's blocks: with ``whole`` the gradients
    are whole over the FSDP ranks (the coded step's), clipped as they
    are and then cut to this rank's blocks, else they are those blocks
    already.  Returns the metrics."""
    split = dict(ctx=ctx, axes=axes, stage=stage, stage_axes=st_axes)
    fsdp = data is not None and any(d is not None for d in data)
    norm_split = dict(split, data=None if whole else data)
    with torch.no_grad(), obs.span("coded.update"):
        if tcfg.grad_clip > 0:
            clip_by_global_norm_(grads, tcfg.grad_clip, **norm_split)
        grad_norm = global_norm(grads, **norm_split)
        lr = lr_at(step).to(grads[0].device)
        kw = split if ctx.active or stage.active else {}
        if fsdp:
            if whole:  # in place: each whole leaf freed with its block
                for i, d in enumerate(data):
                    if d is not None:
                        grads[i] = fsdp_block(grads[i], *d)
            kw = dict(kw, data=data)
        optimizer.apply_(grads, opt_state, params, lr, tcfg.weight_decay,
                         **kw)
    metrics = dict(metrics)
    metrics["lr"] = lr
    metrics["grad_norm"] = grad_norm
    return metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    optimizer=None, ctx: ShardCtx = NULL_CTX,
                    dp_group=None, fsdp=None, sharded_accum: bool = False,
                    moe_ep_axis: str = "model") -> Callable:
    """``train_step(params, opt_state, batch, step) → (params, opt_state,
    metrics)``; params and state are updated in place.  The pipeline's
    options (``pp_stages``, ``microbatches``) are the dist step's: one
    host ignores them, as the reference's does.

    Under an active ``ctx`` (a "model" axis: tensor parallelism, with
    ``seq_shard`` sequence parallelism) the params are this rank's
    slices (``dist.sharding.shard_axis`` with ``moe_ep_axis``): the
    gradients go through :func:`tp_correct` and the update reduces over
    "model".  ``dp_group`` (a process group, or the dry run's
    ``CountingGroup``) holds the data-parallel ranks, each with its own
    rows of the global batch: the gradients and the loss are then
    averaged over it, where the reference's pjit step has XLA insert that
    reduction (the global batch's mean where every rank's rows carry the
    same weight sum, as the dry run's do).

    ``fsdp`` (flat key → ``(axis, context, rest)``, or None for a whole
    leaf) stores the params and the optimizer state as this rank's FSDP
    blocks: a split leaf is gathered over its context's ranks at entry
    and its accumulated gradient reduce-scattered over them once (then
    summed over ``rest``, the other data-parallel ranks: a group, or
    None), a whole one all-reduced over ``dp_group``; the clip's norm
    and the update run on the blocks.  ``sharded_accum`` (with
    microbatches) reduces each microbatch's gradient into a
    block-shaped float32 accumulator, the reference's
    ``accum_shardings``."""
    if optimizer is None:
        optimizer = make_optimizer(default_optimizer_name(cfg, tcfg))
    lr_at = cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    axes_by_key = param_axes(cfg, ctx.tp, moe_ep_axis) if ctx.active \
        else None
    micro = bool(tcfg.microbatch and tcfg.microbatch > 0)
    per_micro = sharded_accum and micro and dp_group is not None

    def dp_reduce(grads, splits):
        """The sums over the data-parallel ranks: a split leaf's block of
        it, a whole leaf whole."""
        out = []
        for g, sp in zip(grads, splits):
            if sp is None:
                out.append(all_reduce(g, dp_group))
                continue
            ax, c, rest = sp
            g = reduce_scatter(g, ax, c.rank, c.tp, c.group)
            out.append(g if rest is None else all_reduce(g, rest))
        return out

    def grads_of(params, batch, each=None):
        if not micro:
            grads, m = _grads(params, cfg, batch, ctx=ctx)
            return grads, {"loss": m["loss"]}
        B = batch["tokens"].shape[0]
        mb = min(tcfg.microbatch, B)
        n_micro = max(B // mb, 1)
        if n_micro * mb != B:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"microbatches of {mb}")
        acc, lsum = None, None
        for i in range(n_micro):
            rows = _batch_rows(batch, B, slice(i * mb, (i + 1) * mb))
            g, m = _grads(params, cfg, rows, ctx=ctx)
            if each is not None:
                g = each([x.to(torch.float32) for x in g])
            if acc is None:
                acc = [x.to(torch.float32) for x in g]
                lsum = m["loss"]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
                lsum = lsum + m["loss"]
            del g
        if "denom" in batch:
            # fixed-denominator (coded) loss: microbatch losses SUM to
            # the full-batch loss — no /n_micro
            return acc, {"loss": lsum}
        return [a / n_micro for a in acc], {"loss": lsum / n_micro}

    def train_step(params, opt_state, batch, step):
        keys = leaf_keys(params)
        splits = [fsdp.get(k) if fsdp else None for k in keys]
        data = [None if sp is None else sp[:2] for sp in splits]
        whole = params
        if any(splits):
            whole = _tree.unflatten_like(
                params, fsdp_gather(_tree.leaves(params), data))
        each = (lambda g: dp_reduce(g, splits)) if per_micro else None
        grads, metrics = grads_of(whole, batch, each)
        del whole
        axes = None
        if ctx.active:
            axes = [axes_by_key[k] for k in keys]
            grads = tp_correct(grads, [a is not None for a in axes], ctx)
        if dp_group is not None:
            n = group_size(dp_group)
            if not per_micro:
                grads = dp_reduce(grads, splits)
            for g in grads:
                g.div_(n)
            metrics["loss"] = all_reduce(metrics["loss"], dp_group).div_(n)
        metrics = _finish(params, opt_state, grads, optimizer, tcfg, lr_at,
                          step, metrics, ctx, axes,
                          data=data if any(splits) else None)
        return params, opt_state, metrics

    train_step.optimizer = optimizer
    return train_step


def tp_correct(grads, sharded, ctx: ShardCtx):
    """A rank's gradients of the model-replicated objective → exact, in
    place (``sharded``: each leaf's ``model_sharded_mask`` entry).  Each
    rank's backward yields ``∂(Σ_ranks φ)/∂(its copy)`` (the
    collectives' transposes are JAX's): sharded leaves carry a uniform
    tp factor; replicated leaves also hold only their own rank's partial
    paths, so they are summed over "model" first."""
    if not ctx.active:
        return grads
    for i, (g, split) in enumerate(zip(grads, sharded)):
        if split:
            g.div_(ctx.tp)
        else:
            grads[i] = ctx.reduce_sum(g).div_(ctx.tp)
    return grads


def _make_dist_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                          optimizer=None) -> Callable:
    """The coded step on ``mesh`` (:class:`repro_torch.dist.mesh.OneCardMesh`
    or :class:`~repro_torch.dist.mesh.DistMesh`).

    Returns ``train_step(params, opt_state, batch, lam, residual, step)
    → (params, opt_state, residual, metrics)``.  Group (i, j) takes its
    rows of the batch — the examples of worker (i, j)'s assigned parts,
    weighted by the coding coefficients only — and its gradient is its
    message G_ij (eq. 22).  ``lam`` is the (pods, data) λ array, a
    runtime operand: drops and replans change only its values.  With
    ``tcfg.grad_compression`` set, ``residual`` is the list of per-pod EF
    residual leaves ``(n_pods, *leaf.shape)``, updated in place; pass an
    empty list otherwise.  The decoded loss is Σ_ij λ_ij L_ij.

    MoE archs: the λ-weighted decode is exact for the coeff-weighted data
    loss only, so group (i, j) differentiates ``λ_ij · L_ij + (AUX_WEIGHT
    / n_groups) · aux_ij`` — the aux regularizer decoded with uniform
    weights, stragglers included, so it does not depend on the straggler
    pattern — and the two-stage sum runs with unit weights.  The metrics
    then carry ``aux_loss`` = Σ_ij aux_ij / n_groups.

    On a ``DistMesh`` with a "model" axis of ``tp > 1`` ranks the step
    runs Megatron tensor parallelism: params are this rank's slices
    (``dist.sharding.shard_axis``), each group's gradient goes through
    :func:`tp_correct` before the coded decode, and the group's loss is
    already equal on every "model" rank (the cross-entropy summed over
    it once), so the decode sums it over (data, pod) only.  With
    ``tcfg.seq_shard_activations`` the ranks also split the sequence
    between the TP collective pairs (the ``ShardCtx`` of the step has
    ``seq_shard``) and the correction keys off ``seq_sharded_mask``: a
    replicated leaf's gradient is then a seq-block partial, which the
    psum over "model" completes.  A batch's ``enc_frames`` (whisper)
    reach the loss with its rows.

    On a ``DistMesh`` with a "stage" axis of ``pp > 1`` ranks the step
    runs pipeline parallelism: this rank's params hold its stage's block
    of the ``groups`` stacks (``dist.sharding.stage_axes``) and the
    replicated rest, each group's rows split into ``tcfg.microbatches
    or pp`` microbatches, and :func:`_pipeline_grads` runs them through
    the stages on a GPipe schedule.  Its gradients are exact for the
    stage's own block; a replicated leaf's hold only this stage's paths,
    so ``stage_correct`` sums them over "stage" (no ``/pp``: the
    schedule differentiates the loss once, not a stage-replicated copy
    of it, as the reference's single program does), once per pod partial
    after the data sum and before the quantized hop (linear, as the
    decode is).  The loss and the aux are then summed over "stage" once.
    At one stage ``tcfg.microbatches`` is ignored, as the reference's
    step ignores it.

    With ``tcfg.fsdp`` on a mesh whose data ranks are ranks of their own
    (``mesh.data_ctx`` active) the params and the optimizer state are
    this rank's FSDP blocks (``dist.sharding.data_axes``): the step
    gathers the whole leaves over "data" at entry, runs the groups, the
    coded psum, the hop and the clip on whole leaves exactly as without
    FSDP, and updates only this rank's blocks; the whole copies go when
    it returns.  FSDP changes where the state lives, not what is
    computed: sgd, momentum and adamw give the ``fsdp=False`` bits.
    """
    from repro_torch.dist import grad_sync

    if optimizer is None:
        optimizer = make_optimizer(default_optimizer_name(cfg, tcfg))
    lr_at = cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    compressed = tcfg.grad_compression != "none"
    if compressed:
        from repro_torch.dist import compression

        if tcfg.grad_compression not in compression.COMPRESSION_MODES:
            raise ValueError(
                f"grad_compression={tcfg.grad_compression!r} not in "
                f"{('none',) + compression.COMPRESSION_MODES}")

    n_groups = mesh.pods * mesh.data
    ctx = getattr(mesh, "ctx", NULL_CTX)
    if tcfg.seq_shard_activations:
        ctx = dataclasses.replace(ctx, seq_shard=True)
    pp, stage = mesh.pp, mesh.stage_ctx
    M = 1
    if pp > 1:
        validate_pp(cfg, pp, microbatches=tcfg.microbatches)
        M = tcfg.microbatches or pp
    axes_by_key = param_axes(cfg, ctx.tp)
    stage_by_key = stage_axes(cfg, pp)
    mask = (seq_sharded_mask if ctx.sp else model_sharded_mask)(cfg,
                                                                  ctx.tp)
    stage_mask = stage_sharded_mask(cfg, pp)
    data = getattr(mesh, "data_ctx", NULL_CTX) if tcfg.fsdp else NULL_CTX
    data_by_key = data_axes(cfg, data.tp) if data.active else {}

    def train_step(params, opt_state, batch, lam, residual, step):
        B = batch["tokens"].shape[0]
        keys = leaf_keys(params)
        axes = [axes_by_key[k] for k in keys]
        st_axes = [stage_by_key[k] for k in keys]
        sharded = [mask[k] for k in keys]
        staged = [stage_mask[k] for k in keys]
        fsdp = None
        stored = params
        if data.active:
            fsdp = [None if data_by_key[k] is None else (data_by_key[k], data)
                    for k in keys]
            params = _tree.unflatten_like(
                stored, fsdp_gather(_tree.leaves(stored), fsdp))

        def group_fn(pod, data):
            rows = mesh.group_rows(pod, data, B)
            local = _batch_rows(batch, B, rows)
            lam_ij = float(np.asarray(lam, np.float32)[pod, data])
            if pp > 1:
                # MoE: λ in the objective, the aux with uniform weights
                coefs = (lam_ij, tf.AUX_WEIGHT / n_groups) if cfg.is_moe \
                    else (1.0, tf.AUX_WEIGHT)
                grads, m = _pipeline_grads(params, cfg, local, mesh, ctx, M,
                                           *coefs)
            elif not cfg.is_moe:
                grads, m = _grads(params, cfg, local, ctx=ctx)
            else:
                grads, m = _grads(
                    params, cfg, local,
                    objective=lambda m: (lam_ij * m["loss"] + (
                        tf.AUX_WEIGHT / n_groups) * m["aux_loss"]), ctx=ctx)
            grads = tp_correct(grads, sharded, ctx)
            if not cfg.is_moe:
                return grads, m["loss"]
            # aux_ij / n_groups rides beside the loss through its sums
            return grads, torch.stack([lam_ij * m["loss"],
                                       m["aux_loss"] / n_groups])

        def stage_correct(part):
            """A pod partial's replicated leaves summed over "stage"."""
            return [g if split else stage.reduce_sum(g)
                    for g, split in zip(part, staged)]

        # MoE: λ is inside each group's objective, so the sums run unweighted
        lam_sum = np.ones_like(np.asarray(lam, np.float32)) if cfg.is_moe \
            else lam
        correct = stage_correct if pp > 1 else None
        if compressed:
            grads, loss = grad_sync.compressed_coded_psum(
                mesh, group_fn, lam_sum, residual,
                block=tcfg.grad_compression_block,
                mode=tcfg.grad_compression, pod_correct=correct)
        else:
            grads, loss = grad_sync.coded_weighted_psum(
                mesh, group_fn, lam_sum, pod_correct=correct)
        # only the last stage holds the loss terms; every stage its aux
        loss = stage.reduce_sum(loss)
        metrics = {"loss": loss[0], "aux_loss": loss[1]} if cfg.is_moe \
            else {"loss": loss}
        del params  # the whole copies, under FSDP
        metrics = _finish(stored, opt_state, grads, optimizer, tcfg, lr_at,
                          step, metrics, ctx, axes, stage, st_axes, fsdp,
                          whole=True)
        return stored, opt_state, residual, metrics

    train_step.optimizer = optimizer
    return train_step


def _pipeline_grads(params, cfg: ModelConfig, local, mesh, ctx: ShardCtx,
                    M: int, loss_coef: float, aux_coef: float):
    """One (pod, data) group's gradients on this stage of a pipeline →
    (gradient leaves in leaf order, ``{"loss", "aux_loss"}``).

    GPipe on an explicit schedule: the forward of every microbatch in
    turn (stage 0 embeds it, the others receive the previous stage's
    output; the stage's block of the group stacks runs; the last stage
    runs the rest layers, the head and the cross-entropy, the others
    send their output on), then the backward in reverse order (the last
    stage seeds ``loss_coef · Σ nll·w / denom + aux_coef · aux / M``,
    the others the cotangent the next stage sends back, plus their own
    layers' aux; the cotangent of the stage's input goes back to the
    previous stage).  No cell is computed off the schedule, and the
    handoffs never enter autograd: a stage differentiates only its own
    graph, and the gradients accumulate over microbatches into the
    params' ``.grad``.  Every rank pair issues its handoffs in one order
    (forwards 0…M−1, then backwards M−1…0), so the chain of stages
    cannot deadlock.  The whisper encoder runs once on every stage over
    the group's whole batch; its output's cotangent accumulates over the
    microbatches and runs back through it once.  The loss terms are the
    reference's: ``denom`` the batch's (else the total weight), the aux
    the per-microbatch mean.  ``loss`` is this stage's share (0 but on
    the last stage) and ``aux_loss`` its layers' aux: the step sums both
    over "stage"."""
    first, last = mesh.stage == 0, mesh.stage == mesh.pp - 1
    leaves = _tree.leaves(params)
    for p in leaves:
        p.grad = None
    tokens = local["tokens"]
    Bl, S = tokens.shape
    if Bl % M:
        raise ValueError(
            f"{cfg.name}: pipeline parallelism needs the per-group "
            f"batch ({Bl} rows) divisible by microbatches={M}")
    mb = Bl // M
    micro = [_batch_rows({k: v for k, v in local.items()
                          if k != "enc_frames"}, Bl,
                         slice(i * mb, (i + 1) * mb)) for i in range(M)]
    S_loc = S // ctx.tp if ctx.sp else S
    act = (mb, S_loc, cfg.d_model)
    act_dtype = tf._torch_dtype(cfg.dtype)
    dev = tokens.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    saved = []
    nll_tot, w_tot, aux_tot = zero, zero, zero
    with torch.enable_grad(), obs.span("model.forward"):
        pc = tf.cast_params(params, cfg)
        enc_out = enc_in = None
        if cfg.is_encdec:
            enc_out = tf.encode_frames(pc, cfg, local["enc_frames"], ctx)
            enc_in = enc_out.detach().requires_grad_(True)
        for i, m in enumerate(micro):
            pos = tf.default_positions(cfg, m["tokens"], m.get("positions"))
            rope = tf.rope_of(cfg, pos)
            enc_i = None if enc_in is None else enc_in[i * mb:(i + 1) * mb]
            if first:
                x_in, _ = tf.embed_tokens(pc, cfg, m["tokens"], pos,
                                          m.get("visual_embeds"), ctx)
            else:
                x_in = mesh.recv_prev(torch.empty(
                    act, dtype=act_dtype, device=dev)).requires_grad_(True)
            x, aux = tf.apply_groups(pc["groups"], cfg, x_in, rope, enc_i,
                                     ctx)
            if last:
                nll, w, aux_rest = tf.head_loss_terms(
                    pc, cfg, x, m["targets"], m.get("weights"), rope, enc_i,
                    ctx)
                aux = aux + aux_rest
                nll_tot, w_tot = nll_tot + nll.detach(), w_tot + w.detach()
                saved.append((x_in, nll, aux))
            else:
                if x.dtype != act_dtype or tuple(x.shape) != act:
                    raise RuntimeError(
                        f"stage {mesh.stage} output {tuple(x.shape)} "
                        f"{x.dtype}, the handoff carries {act} {act_dtype}")
                mesh.send_next(x)
                saved.append((x_in, x, aux))
            aux_tot = aux_tot + aux.detach() / M
    denom = local.get("denom")
    if denom is None:
        denom = torch.clamp(w_tot, min=1.0)
    with torch.enable_grad(), obs.span("model.backward"):
        for i in reversed(range(M)):
            x_in, out, aux = saved[i]
            saved[i] = None
            if last:
                obj = loss_coef * out / denom
                if aux.requires_grad:
                    obj = obj + (aux_coef / M) * aux
                torch.autograd.backward([obj])
            else:
                seeds = [(out, mesh.recv_next(torch.empty_like(out)))]
                if aux.requires_grad:
                    seeds.append((aux, torch.full_like(aux, aux_coef / M)))
                torch.autograd.backward([t for t, _ in seeds],
                                        [g for _, g in seeds])
            if not first:
                mesh.send_prev(x_in.grad)
            del x_in, out, aux
        if enc_out is not None and enc_in.grad is not None:
            torch.autograd.backward([enc_out], [enc_in.grad])
    grads = []
    for p in leaves:
        grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
        p.grad = None
    loss = nll_tot / denom if last else zero
    return grads, {"loss": loss, "aux_loss": aux_tot}


# ----------------------------------------------------------------------
# serving steps, and the dry run's inputs on the meta device
# ----------------------------------------------------------------------
def make_serve_step(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX) -> Callable:
    """serve_step(params, cache, token) → (logits, new_cache)."""

    def serve_step(params, cache, token):
        return tf.decode_step(params, cfg, token, cache, ctx=ctx)

    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX,
                      fsdp=None) -> Callable:
    """prefill_step(params, batch) → (last logits, cache).  With ``fsdp``
    (as :func:`make_train_step`'s) the params are this rank's FSDP
    blocks, each split leaf gathered once at entry."""

    def prefill_step(params, batch):
        if fsdp:
            keys = leaf_keys(params)
            params = _tree.unflatten_like(params, fsdp_gather(
                _tree.leaves(params),
                [None if fsdp.get(k) is None else fsdp[k][:2]
                 for k in keys]))
        logits, cache, _ = tf.forward(
            params, cfg, batch["tokens"],
            positions=batch.get("positions"),
            enc_frames=batch.get("enc_frames"),
            return_cache=True,
            last_only=True,
            ctx=ctx,
        )
        return logits[:, -1], cache

    return prefill_step


def input_specs(cfg: ModelConfig, shape: ShapeConfig, batch: int = 0,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of a cell: empty tensors on
    ``device`` (``meta``: shapes only, no memory) with the reference's
    keys, shapes and dtypes (``batch`` rows, default the cell's global
    batch).  Frontend stubs (whisper frames / VLM patch embeds) appear
    as precomputed embedding tensors."""
    B, S = batch or shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((B, S), i32)}
        if shape.kind == "train":
            specs["targets"] = spec((B, S), i32)
            specs["weights"] = spec((B, S), f32)
        if cfg.mrope_sections:
            specs["positions"] = spec((3, B, S), i32)
        if cfg.is_encdec:
            specs["enc_frames"] = spec((B, cfg.enc_len, cfg.d_model), f32)
        return specs
    # decode: one new token against a seq_len cache
    return {"token": spec((B, 1), i32)}


def fsdp_blocks(params: PyTree, fsdp) -> PyTree:
    """This rank's FSDP blocks of ``params`` (``fsdp`` as
    :func:`make_train_step`'s), each in a storage of its own (a block of
    a ``meta`` tensor then counts only its own bytes)."""
    from repro_torch.checkpoint.params import _flatten, _unflatten

    out = {}
    for k, v in _flatten(params).items():
        sp = (fsdp or {}).get(k)
        out[k] = v if sp is None else fsdp_block(v, *sp[:2]).clone()
    return _unflatten(out)


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig, optimizer=None,
                   tp: int = 1, rank: int = 0, moe_ep_axis: str = "model",
                   fsdp=None):
    """(params, opt_state) on the ``meta`` device: the reference's
    shapes and dtypes (params in ``cfg.param_dtype``, the norm scales in
    float32 whatever it says), this ``rank``'s slices at ``tp`` > 1 (the
    experts whole with ``moe_ep_axis="data"``), and with ``fsdp`` its
    FSDP blocks of those, the optimizer state made on the blocks."""
    from repro_torch.checkpoint.params import (
        _flatten,
        _unflatten,
        shard_array,
    )

    if optimizer is None:
        optimizer = make_optimizer(default_optimizer_name(cfg, tcfg))
    axes = param_axes(cfg, tp, moe_ep_axis)
    params = _flatten(tf.init_params(
        cfg, device="meta", dtype=tf._torch_dtype(cfg.param_dtype)))
    params = _unflatten({
        k: shard_array(v.float() if k.endswith("/scale") else v,
                       axes[k], tp, rank).clone()
        for k, v in params.items()})
    params = fsdp_blocks(params, fsdp)
    return params, optimizer.init(params)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, batch: int = 0,
                   tp: int = 1):
    """The decode cache of a cell on the ``meta`` device (``batch`` rows,
    default the cell's global batch; this rank's heads at ``tp``): K/V
    in the model dtype (``cfg.dtype``), the recurrent states in float32,
    as the reference's; an encoder–decoder model's also holds
    ``cross_pos``, the cross decode's query position on the device."""
    return tf.init_cache(cfg, batch or shape.global_batch, shape.seq_len,
                         device="meta", tp=tp)
