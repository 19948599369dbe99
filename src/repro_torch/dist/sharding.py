"""Tensor parallelism of the port: the ``ShardCtx`` seam and the per-leaf
rule.

PyTorch counterpart of the tensor-parallel part of
``repro.dist.sharding``:

  * :class:`ShardCtx` — the execution seam the model code calls
    (``psum`` finishes a row-parallel matmul, ``all_gather`` rebuilds
    the d-sharded embedding and the expert-parallel router's logits,
    ``local_block`` slices a replicated array to this rank's feature
    block, ``pmax``/``axis_index`` for the vocab-parallel cross-entropy;
    under sequence parallelism ``gather_seq``, ``scatter_seq`` and
    ``psum_scatter`` move the residual stream between the local sequence
    block and the whole sequence, and ``no_sp`` turns them off).  The
    reference runs them inside ``shard_map``; the port is SPMD, one
    process a rank, and they are collectives over the "model" process
    group.  Their gradients are the transposes JAX takes (``psum`` →
    ``psum``; a tiled all-gather ↔ a reduce-scatter; a static slice → a
    zero-padded scatter into the full length, no collective), so a
    rank's backward computes what a shard's does in the reference, and
    the train step corrects it as the reference's ``tp_correct`` does.
  * :func:`validate_tp` and :func:`validate_seq_shard` — the reference's
    checks, with their messages (and the latter's warning for the
    recurrent kinds);
  * :func:`shard_axis` — ``_param_rule`` / ``params_pspecs(head_aligned=
    True)`` projected onto the "model" axis (``model_axis_only``) and
    fitted to divisibility (``fit_spec``): the axis a leaf is split on,
    or None (replicated); :func:`param_axes` applies it to a config's
    flat keys, :func:`model_sharded_mask` is its boolean view and
    :func:`seq_sharded_mask` the same set for the SP step.

The collectives move CUDA tensors over gloo when several ranks share a
card (NCCL refuses two ranks on one device): gloo takes CUDA tensors in
``all_reduce`` and ``broadcast`` only, so there an all-gather is the
``all_reduce`` of a zeroed ``(tp, …)`` buffer holding this rank's block,
summed as bytes (exact for any dtype; gloo has no fp8), and a
reduce-scatter is an ``all_reduce`` then this rank's block.  Under NCCL
they are ``all_gather_into_tensor`` and ``reduce_scatter_tensor``.  The
choice is made by the backend's name.

Pipeline parallelism adds a "stage" axis (the reference's stage helpers):
:func:`stage_layer_ranges`, :func:`validate_pp` (its messages),
:func:`stage_axes` / :func:`stage_sharded_mask` (only the ``groups``
stacks split, on their leading axis), and the stage handoff
:func:`send_to` / :func:`recv_from` under the ``pp.collective`` span
(:data:`PP_SPAN`; their NCCL branch has not run yet: one card admits
no NCCL world of two ranks).  A :class:`ShardCtx` over the stage group (``span``
:data:`PP_SPAN`) carries the stage sums: the gradient correction, the
optimizer's reductions and the gathers of stage-split leaves.

The dry run (``launch.op_analysis``) runs one rank's step on the
``meta`` device with a :class:`CountingGroup` as the group: every
collective here then moves nothing, returns a result of the right shape
and records itself (kind, operand bytes, link bytes) in the group's
:class:`CollectiveTally`; with :data:`TALLY` set, the collectives of a
real world are recorded the same way.

FSDP over "data" (the reference's default ``fsdp=True``) is the "data"
entries of the same rule: :func:`fsdp_split` gives the dim a leaf's FSDP
axis sits on and the axes it spans after fitting (``mode="dp_only"``:
"data" and "model" together, no TP), :func:`data_axes` the "data" dims
of a config's leaves; a rank stores its block of each split leaf and
:func:`fsdp_gather` rebuilds the whole leaves at step entry (the
``fsdp.collective`` span, :data:`FSDP_SPAN`); :func:`fsdp_block` cuts a
rank's block back out.  With :class:`BlockOutputs` a rematerialized
layer keeps the outputs of its sublayers' finishing collectives (the
reference's ``remat_policy="save_block_outputs"``) and its recompute
runs none of them.  The pjit anchors and ``serve_shardings`` are XLA's
and have no counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs


# ----------------------------------------------------------------------
# collectives on a process group
# ----------------------------------------------------------------------
#: the ``obs.span`` around every collective (a no-op unless a
#: ``torch.profiler`` records): a profile splits out the time inside them
SPAN = "tp.collective"
#: the span around the pipeline's collectives: the stage handoffs and the
#: sums over the "stage" axis
PP_SPAN = "pp.collective"
#: the span around FSDP's gathers of the params over "data"
FSDP_SPAN = "fsdp.collective"


#: the collectives' kinds, as the reference's HLO names them
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute")
#: ranks a host holds (one card each) and ranks a pod holds, for the
#: tallies' link classes (``launch.mesh``'s production layout)
HOST_RANKS, POD_RANKS = 8, 256


class CollectiveTally:
    """Per kind of collective: ``count``, ``operand_bytes``,
    ``output_bytes``, ``link_bytes`` (what one rank puts on its links: a
    ring all-reduce 2(n−1)/n of the operand, an all-gather (n−1)/n of its
    output, a reduce-scatter (n−1)/n of its operand, a handoff the
    operand), ``link_bytes_bf16eq`` (float32 at 2 bytes),
    ``cross_host_link_bytes`` and ``cross_pod_link_bytes`` (the link
    bytes of groups whose ranks span hosts of :data:`HOST_RANKS` cards or
    pods of :data:`POD_RANKS`), and ``link_s`` (the link bytes over the
    group's link rate, where the group knows it)."""

    def __init__(self):
        self.by_kind = {c: dict(count=0, operand_bytes=0.0,
                                output_bytes=0.0, link_bytes=0.0,
                                link_bytes_bf16eq=0.0,
                                cross_host_link_bytes=0.0,
                                cross_pod_link_bytes=0.0, link_s=0.0)
                        for c in COLLECTIVES}

    def add(self, kind: str, x: torch.Tensor, n: int,
            ranks: Sequence[int], link: float = 0.0) -> None:
        """One collective of ``kind`` over ``n`` ranks (global ``ranks``)
        with operand ``x`` on this rank."""
        operand = x.numel() * x.element_size()
        eq = x.numel() * (2 if x.dtype in (torch.float32, torch.float64)
                          else x.element_size())
        output = operand * (n if kind == "all-gather" else 1)
        if kind == "reduce-scatter":
            output = operand // n
        share = {"all-reduce": 2.0 * (n - 1) / n,
                 "all-gather": float(n - 1),
                 "reduce-scatter": (n - 1) / n}.get(kind, 1.0)
        rec = self.by_kind[kind]
        rec["count"] += 1
        rec["operand_bytes"] += operand
        rec["output_bytes"] += output
        rec["link_bytes"] += share * operand
        rec["link_bytes_bf16eq"] += share * eq
        if len({r // HOST_RANKS for r in ranks}) > 1:
            rec["cross_host_link_bytes"] += share * operand
        if len({r // POD_RANKS for r in ranks}) > 1:
            rec["cross_pod_link_bytes"] += share * operand
        if link:
            rec["link_s"] += share * eq / link

    def total(self, key: str) -> float:
        return sum(v[key] for v in self.by_kind.values())


#: the tally of a real world's collectives (None: not recorded)
TALLY: Optional[CollectiveTally] = None


@dataclasses.dataclass(frozen=True, eq=False)
class CountingGroup:
    """A process group of the dry run: ``size`` ranks, this rank's group
    of global ``ranks`` in the production layout, each rank on a link of
    ``link`` bytes/s each way.  Its collectives move nothing (a result of
    the right shape, on the operand's device) and record themselves in
    ``tally``."""

    size: int
    ranks: Tuple[int, ...]
    link: float
    tally: CollectiveTally


def group_size(group) -> int:
    """The ranks of ``group``: a :class:`CountingGroup`'s size, or a
    process group's (``None``: the world's)."""
    if isinstance(group, CountingGroup):
        return group.size
    return dist.get_world_size(group)


def _record(kind: str, x: torch.Tensor, group) -> bool:
    """Record a collective in its tally → whether ``group`` counts only
    (a :class:`CountingGroup`: nothing to move)."""
    if isinstance(group, CountingGroup):
        group.tally.add(kind, x, group.size, group.ranks, group.link)
        return True
    if TALLY is not None:
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        TALLY.add(kind, x, len(ranks), ranks)
    return False


def _all_reduce(x: torch.Tensor, group, op=None,
                span: str = SPAN) -> torch.Tensor:
    buf = x.detach().clone(memory_format=torch.contiguous_format)
    with obs.span(span):
        dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
    return buf


def all_reduce(x: torch.Tensor, group, op=None,
               span: str = SPAN) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (``x`` is left alone)."""
    if _record("all-reduce", x, group):
        return x.detach().clone(memory_format=torch.contiguous_format)
    return _all_reduce(x, group, op, span)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor as a flat uint8 view (gloo moves
    any dtype that way, fp8 and bf16 included)."""
    return x.reshape(-1).view(torch.uint8)


def send_to(x: torch.Tensor, me: int, peer: int, group) -> None:
    """The stage handoff, sending side: ``x`` to global rank ``peer`` of
    the two-rank ``group`` {me, peer}.  NCCL: ``send``; gloo (whose CUDA
    collectives are ``all_reduce`` and ``broadcast``): a ``broadcast``
    from ``me`` inside the pair, as bytes."""
    x = x.detach().contiguous()
    if _record("collective-permute", x, group):
        return
    with obs.span(PP_SPAN):
        if dist.get_backend(group) == "nccl":
            dist.send(x, dst=peer, group=group)
        else:
            dist.broadcast(_bytes(x), src=me, group=group)


def recv_from(buf: torch.Tensor, peer: int, group) -> torch.Tensor:
    """The stage handoff, receiving side: global rank ``peer``'s tensor
    into the contiguous ``buf`` (its shape and dtype) → ``buf``; a
    handoff is recorded once, by its sender."""
    if isinstance(group, CountingGroup):
        return buf
    with obs.span(PP_SPAN):
        if dist.get_backend(group) == "nccl":
            dist.recv(buf, src=peer, group=group)
        else:
            dist.broadcast(_bytes(buf), src=peer, group=group)
    return buf


def gather_rows(out: torch.Tensor, index: int, local: torch.Tensor,
                group, span: str = SPAN) -> None:
    """Every member's ``local`` into its row of ``out`` ``(n, *local.
    shape)``, member ``index`` writing row ``index``: an all-gather.

    NCCL: ``all_gather_into_tensor``.  Otherwise (gloo, whose CUDA
    collectives are ``all_reduce`` and ``broadcast``) the ``all_reduce``
    of the zeroed buffer holding this member's row, summed as bytes:
    each byte is its owner's plus zeros, so the result is exact for any
    dtype (and fp8, which gloo lacks, travels as bytes).
    """
    if _record("all-gather", local, group):
        out[index].copy_(local)
        return
    if dist.get_backend(group) == "nccl":
        with obs.span(span):
            dist.all_gather_into_tensor(
                out.view(torch.uint8), local.contiguous().view(torch.uint8),
                group=group)
        return
    out.zero_()
    out[index].copy_(local)
    with obs.span(span):
        dist.all_reduce(out.view(torch.uint8), group=group)


def all_gather_cat(x: torch.Tensor, axis: int, index: int, n: int,
                   group, span: str = SPAN) -> torch.Tensor:
    """The members' blocks of ``x`` concatenated along ``axis`` (tiled)."""
    buf = x.new_empty((n,) + tuple(x.shape))
    gather_rows(buf, index, x.detach(), group, span)
    return torch.cat(buf.unbind(0), dim=axis % x.ndim)


def reduce_scatter(x: torch.Tensor, axis: int, index: int, n: int,
                   group) -> torch.Tensor:
    """The sum of the members' ``x`` over ``group``, member ``index``'s
    block of ``n`` equal blocks along ``axis`` (tiled reduce-scatter).

    NCCL: ``reduce_scatter_tensor`` over ``axis`` moved to the front.
    Otherwise (gloo) the ``all_reduce`` of a copy, then the block."""
    axis %= x.ndim
    local = x.shape[axis] // n
    if _record("reduce-scatter", x, group):
        return x.detach().narrow(axis, index * local, local).contiguous()
    if dist.get_backend(group) == "nccl":
        src = x.detach().movedim(axis, 0).contiguous()
        out = src.new_empty((local,) + tuple(src.shape[1:]))
        with obs.span(SPAN):
            dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, axis).contiguous()
    full = _all_reduce(x, group)
    return full.narrow(axis, index * local, local).contiguous()


class BlockOutputs:
    """The reference's ``remat_policy="save_block_outputs"`` for one
    rematerialized layer: its original forward keeps the output of each
    sublayer's finishing collective (a ``psum_scatter`` of a
    :class:`ShardCtx` with ``block_out``), and its recompute takes them
    back in order instead of running the collective again, as XLA drops
    the recomputed all-reduce whose output the policy saved.  The
    collectives are host calls that no dispatch-level policy can cache
    (gloo's reduce in place), so the saving happens here, through
    :meth:`contexts`, a ``context_fn`` of ``torch.utils.checkpoint``."""

    _active = threading.local()

    def __init__(self):
        self.saved: List[torch.Tensor] = []

    def contexts(self):
        """(the original forward's context, the recompute's)."""
        return self._use("save"), self._use("replay")

    @contextlib.contextmanager
    def _use(self, mode):
        prev = getattr(BlockOutputs._active, "cur", None)
        BlockOutputs._active.cur = (self, mode)
        try:
            yield
        finally:
            BlockOutputs._active.cur = prev

    @staticmethod
    def finish(x: torch.Tensor, collective) -> torch.Tensor:
        """``collective(x)`` (a sublayer's finishing collective), saved
        by the original forward of the active layer and handed back by
        its recompute; outside such a layer just ``collective(x)``."""
        cur = getattr(BlockOutputs._active, "cur", None)
        if cur is None:
            return collective(x)
        owner, mode = cur
        if mode == "replay":
            return owner.saved.pop(0).detach()
        out = collective(x)
        owner.saved.append(out.detach())
        return out


class _PSum(torch.autograd.Function):
    """``psum`` over the model group; its transpose is ``psum`` too."""

    @staticmethod
    def forward(ctx, x, sc, block=False):
        ctx.sc = sc
        if block:
            return BlockOutputs.finish(x, lambda y: all_reduce(y, sc.group))
        return all_reduce(x, sc.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.sc.group), None, None


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather``; its transpose is the reduce-scatter of the
    cotangent (``psum_scatter``: summed over the group, this rank's
    block)."""

    @staticmethod
    def forward(ctx, x, sc, axis):
        ctx.sc, ctx.axis = sc, axis % x.ndim
        return all_gather_cat(x, axis, sc.rank, sc.tp, sc.group)

    @staticmethod
    def backward(ctx, g):
        sc = ctx.sc
        return reduce_scatter(g, ctx.axis, sc.rank, sc.tp, sc.group), \
            None, None


class _PSumScatter(torch.autograd.Function):
    """Tiled reduce-scatter (``psum_scatter``); its transpose is the tiled
    all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, sc, axis):
        ctx.sc, ctx.axis = sc, axis % x.ndim

        def rs(y):
            return reduce_scatter(y, axis, sc.rank, sc.tp, sc.group)

        return BlockOutputs.finish(x, rs) if sc.block_out else rs(x)

    @staticmethod
    def backward(ctx, g):
        sc = ctx.sc
        return all_gather_cat(g.contiguous(), ctx.axis, sc.rank, sc.tp,
                              sc.group), None, None


class _ScatterSeq(torch.autograd.Function):
    """This rank's block of a replicated value along ``axis`` (a static
    slice, no collective); its transpose writes the cotangent into a
    zero-padded full-length buffer, again with no collective."""

    @staticmethod
    def forward(ctx, x, start, local, axis):
        ctx.full, ctx.start, ctx.axis = x.shape, start, axis % x.ndim
        return x.narrow(ctx.axis, start, local).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.full)
        out.narrow(ctx.axis, ctx.start, g.shape[ctx.axis]).copy_(g)
        return out, None, None, None


# ----------------------------------------------------------------------
# ShardCtx — the execution seam between launch.steps and models/
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The "model" axis as the model code sees it.

    ``tp`` ranks in ``group`` (None: the default group), this process at
    index ``rank`` on it.  Inactive (``tp`` 1) every method is the
    identity, so the model code calls them unconditionally, as the
    reference's does.  Every sharded-or-replicated decision the model
    code makes from it compares a local shape with the config's.
    """

    tp: int = 1
    rank: int = 0
    group: Any = None
    seq_shard: bool = False
    #: the profiler span of its collectives (:data:`PP_SPAN` for a
    #: context over the "stage" axis)
    span: str = SPAN
    #: its ``psum_scatter`` finishes a sublayer whose output a
    #: ``save_block_outputs`` remat keeps (:class:`BlockOutputs`)
    block_out: bool = False

    @property
    def active(self) -> bool:
        return self.tp > 1

    @property
    def sp(self) -> bool:
        return self.active and self.seq_shard

    def no_sp(self) -> "ShardCtx":
        """The context with sequence sharding off, for a sub-stack whose
        sequence must stay whole (whisper's encoder: ``enc_len`` need not
        divide tp, and cross-attention reads the full K/V)."""
        if not self.seq_shard:
            return self
        return dataclasses.replace(self, seq_shard=False)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Finish a row-parallel matmul (partial sums → full value)."""
        if not self.active:
            return x
        return _PSum.apply(x, self)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the group; no gradient (the reference takes it
        of a ``stop_gradient``)."""
        if not self.active:
            return x
        return all_reduce(x, self.group, dist.ReduceOp.MAX, self.span)

    def axis_index(self) -> int:
        return self.rank if self.active else 0

    def all_gather(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """Concatenate the per-rank blocks along ``axis`` (tiled)."""
        if not self.active:
            return x
        return _AllGather.apply(x, self, axis)

    def local_block(self, v: torch.Tensor, local: int,
                    axis: int = -1) -> torch.Tensor:
        """This rank's feature block of a replicated array; a no-op when
        ``v`` already has the local size on ``axis``."""
        if not self.active or v.shape[axis] == local:
            return v
        return v.narrow(axis % v.ndim, self.rank * local, local)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group outside autograd (the optimizer's and
        the step's reductions)."""
        if not self.active:
            return x
        return all_reduce(x, self.group, span=self.span)

    def gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The members' blocks of ``x`` concatenated along ``axis``,
        outside autograd (checkpoints' and tests' gathers)."""
        if not self.active:
            return x
        return all_gather_cat(x.contiguous(), axis, self.rank, self.tp,
                              self.group, self.span)

    def argmax(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """Greedy token of vocab-parallel logits (…, vocab / tp): the
        global argmax, the lowest index on ties, as ``argmax`` over the
        whole vocabulary takes it.  Full logits (…, vocab) take the plain
        ``argmax``."""
        idx = torch.argmax(logits, -1)
        if not self.active or logits.shape[-1] == vocab:
            return idx
        V = logits.shape[-1]
        best = torch.gather(logits, -1, idx[..., None])[..., 0]
        # values and global indices of every rank's local argmax; f64
        # holds both exactly
        mine = torch.stack([best.double(), (idx + self.rank * V).double()])
        allv = all_gather_cat(mine[None], 0, self.rank, self.tp,
                              self.group)  # (tp, 2, …)
        top = allv[:, 0].amax(0)
        # the first rank holding the max has the lowest index: its block
        # comes first and its local argmax is its first max
        first = (allv[:, 0] == top).to(torch.int8).argmax(0)
        return torch.gather(allv[:, 1], 0, first[None])[0].to(idx.dtype)

    # ---- sequence parallelism ----------------------------------------
    def _seq_check(self, x: torch.Tensor, axis: int) -> int:
        if x.shape[axis] % self.tp:
            raise ValueError(
                f"sequence parallelism needs the seq dim (axis {axis}, "
                f"size {x.shape[axis]}) divisible by tp={self.tp}")
        return x.shape[axis] // self.tp

    def gather_seq(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Local sequence block → the full sequence (tiled all-gather);
        the start of every column-parallel in-projection region under SP,
        the identity otherwise."""
        if not self.sp:
            return x
        return _AllGather.apply(x, self, axis)

    def scatter_seq(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """A full-sequence value that is complete on every rank (the
        embedding, an unsharded sublayer's output) → this rank's
        sequence block: a static slice, no collective.  Partial sums take
        :meth:`psum_scatter`."""
        if not self.sp:
            return x
        local = self._seq_check(x, axis)
        return _ScatterSeq.apply(x, self.rank * local, local, axis)

    def psum_scatter(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Finish a row-parallel matmul: :meth:`psum` under plain TP; under
        SP the reduce-scatter over the sequence axis (the same bytes on
        the link; the result holds only the local sequence block).  With
        ``block_out`` the output is a sublayer's (:class:`BlockOutputs`)."""
        if not self.active:
            return x
        if not self.seq_shard:
            return _PSum.apply(x, self, self.block_out)
        self._seq_check(x, axis)
        return _PSumScatter.apply(x, self, axis)


#: inactive context: the one-rank paths and every default caller
NULL_CTX = ShardCtx()


def model_ctx(tp: int) -> ShardCtx:
    """The context of a world that is the "model" axis alone (serving):
    ``tp`` must be the world's size."""
    if tp <= 1:
        return NULL_CTX
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(f"tp={tp} needs a world of {tp} ranks, this one "
                         f"has {world}")
    return ShardCtx(tp=tp, rank=dist.get_rank(), group=None)


# ----------------------------------------------------------------------
# validation
# ----------------------------------------------------------------------
def validate_tp(cfg, tp: int) -> None:
    """Clear error (instead of a shape crash) for a bad ``--tp`` degree.

    Checks the arch config's divisibility constraints for real
    tensor-parallel execution.  KV heads are exempt: when ``n_kv_heads``
    does not divide, K/V projections replicate (Megatron-style GQA
    fallback) as long as the local Q heads still group evenly.
    """
    if tp <= 1:
        return
    errs = []
    kinds = set(cfg.block_pattern)
    if cfg.d_model % tp:
        errs.append(f"d_model={cfg.d_model} not divisible by tp={tp}")
    if kinds & {"global", "local"} or cfg.is_encdec:
        if cfg.n_heads % tp:
            errs.append(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
        elif cfg.n_kv_heads % tp and tp % cfg.n_kv_heads:
            errs.append(
                f"GQA: n_kv_heads={cfg.n_kv_heads} neither divides nor "
                f"is divided by tp={tp} — KV heads can neither shard "
                f"nor replicate consistently"
            )
    if cfg.d_ff > 0 and kinds != {"ssm"}:
        ffd = cfg.d_ff_dense or cfg.d_ff
        if ffd % tp:
            errs.append(f"d_ff={ffd} not divisible by tp={tp}")
    if "ssm" in kinds:
        nh = (cfg.expand * cfg.d_model) // cfg.ssm_head_dim
        if nh % tp:
            errs.append(f"ssm heads={nh} not divisible by tp={tp}")
    if "recurrent" in kinds:
        r = cfg.lru_width or cfg.d_model
        if r % tp:
            errs.append(f"lru_width={r} not divisible by tp={tp}")
    if errs:
        raise ValueError(
            f"{cfg.name}: tensor parallelism tp={tp} violates "
            f"divisibility constraints: " + "; ".join(errs)
        )


def validate_seq_shard(cfg, tp: int, seq_len: int) -> None:
    """Clear error (instead of a shape crash) for a bad ``--seq-shard``.

    Sequence parallelism scatters the (B, S, d) activations over the
    model axis between the TP collective pairs, so S must divide the
    TP degree.  Recurrent kinds (Mamba-2 SSD / RG-LRU) are legal but
    their scan is sequential in seq — those blocks gather the full
    sequence before scanning (only the norm/residual/projection work
    between blocks shards), which a warning makes explicit.
    """
    if tp <= 1:
        raise ValueError(
            f"{cfg.name}: --seq-shard requires tensor parallelism "
            f"(tp={tp}); sequence sharding rides the 'model' mesh axis")
    if seq_len % tp:
        raise ValueError(
            f"{cfg.name}: sequence parallelism needs the sequence "
            f"length divisible by tp: seq_len={seq_len} % tp={tp} != 0")
    rec = set(cfg.block_pattern) & {"ssm", "recurrent"}
    if rec:
        warnings.warn(
            f"{cfg.name}: {sorted(rec)} blocks scan sequentially over "
            f"seq — sequence parallelism falls back to "
            f"gather-before-scan there (norm/residual/projection work "
            f"between blocks still shards)", stacklevel=2)


# ----------------------------------------------------------------------
# the per-leaf rule
# ----------------------------------------------------------------------
# column-parallel (shard the OUTPUT features over "model"): y = x @ W
_COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "w1", "w_gate", "w_lin",
                 "zproj", "xproj", "dtproj", "router", "ws_g", "ws_u"}
# row-parallel (shard the INPUT features; the output needs a psum);
# w_a/w_x (the RG-LRU gates) consume the sharded recurrence width and
# one psum restores both pre-activations
_ROW_PARALLEL = {"wo", "wd", "w2", "out_proj", "w_out", "ws_d", "w_a",
                 "w_x"}
# the MoE's expert-stacked weights (E, in, out): the expert axis
_EXPERT = {"we_g", "we_u", "we_d"}
# depthwise-conv weights (K, channels): channels follow the
# column-parallel projection that feeds them
_CONV_CHANNEL = {"conv_w", "conv_x_w"}
# head-granular weights: only whole heads (or KV groups) shard
_HEAD_OF = {"wq": "q", "wo": "q", "wk": "kv", "wv": "kv"}
# the SSD's head-block leaves: only whole SSD heads shard
_SSM_HEADS = {"zproj", "xproj", "dtproj", "conv_x_w"}


def shard_axis(name: str, shape, cfg, tp: int,
               moe_ep_axis: str = "model") -> Optional[int]:
    """The axis (negative) that leaf ``name`` of full ``shape`` is split
    on over ``tp`` "model" ranks, or None when it is replicated.

    The reference's ``_param_rule`` with ``head_aligned=True`` on the
    "model" axis only (the "data" entries are :func:`fsdp_split`'s),
    then dropped where the dim does not divide (``fit_spec``): K/V
    projections replicate when ``n_kv_heads`` does not divide tp, an
    untied head when the vocabulary does not, the experts (and the
    router's columns) when ``n_experts`` does not.  With ``moe_ep_axis=
    "data"`` the experts ride "data" and are whole on "model".  1-D
    vectors (norm scales, biases, ``A_log``, ``D``, ``dt_bias``,
    ``lam``, ``conv_b``) stay replicated, stacked or not.
    """
    if tp <= 1 or (name in _EXPERT and moe_ep_axis == "data"):
        return None
    nd = len(shape)
    if name in _HEAD_OF:
        heads = cfg.n_heads if _HEAD_OF[name] == "q" else cfg.n_kv_heads
        if not heads or heads % tp:
            return None
    if name in _SSM_HEADS:
        nh = (cfg.expand * cfg.d_model) // cfg.ssm_head_dim \
            if cfg.ssm_head_dim else 0
        if not nh or nh % tp:
            return None
    ax = None
    if name in _EXPERT and nd >= 3:
        ax = -3
    elif name in _COL_PARALLEL and nd >= 2:
        ax = -1
    elif name in _ROW_PARALLEL and nd >= 2:
        ax = -2
    elif name in ("table", "w") and nd >= 2:
        # the embedding (V, d) is d-sharded (gathered at the use site);
        # the untied head (d, V) gives vocab-parallel logits
        ax = -1
    elif name in _CONV_CHANNEL and nd >= 2:
        ax = -1
    if ax is None or shape[ax] % tp:
        return None
    return ax


def _full_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every param leaf's full shape by flat key
    (``checkpoint.params._flatten``'s), made on the ``meta`` device."""
    from repro_torch.checkpoint.params import _flatten
    from repro_torch.models import transformer as tf

    shapes = tf.init_params(cfg, device="meta", dtype=torch.float32)
    return {k: tuple(v.shape) for k, v in _flatten(shapes).items()}


def param_axes(cfg, tp: int, moe_ep_axis: str = "model"
               ) -> Dict[str, Optional[int]]:
    """:func:`shard_axis` of every param leaf of ``cfg``, by flat key,
    from the full shapes."""
    return {k: shard_axis(k.rsplit("/", 1)[-1], v, cfg, tp, moe_ep_axis)
            for k, v in _full_shapes(cfg).items()}


def model_sharded_mask(cfg, tp: int) -> Dict[str, bool]:
    """True per flat key iff the leaf is split over the "model" axis.

    The dist step's gradient correction keys off this: each rank's
    backward computes ``∂(Σ_ranks φ)/∂(its copy)`` of the replicated
    objective, so model-sharded leaves divide by tp and replicated
    leaves psum over "model" then divide by tp.
    """
    return {k: ax is not None for k, ax in param_axes(cfg, tp).items()}


def seq_sharded_mask(cfg, tp: int) -> Dict[str, bool]:
    """The gradient-correction mask of the sequence-parallel step: the
    same set as :func:`model_sharded_mask`, as the reference's.  Under SP
    a replicated leaf (a norm scale, a bias, a per-head vector) is used
    on the local sequence block only, so its per-rank gradient is a
    seq-block partial and the psum over "model" completes the token sum
    (not an average of equal copies); the set of leaves that need it
    and the 1/tp factor are unchanged.  Its own name says which regime
    the step corrects for."""
    return model_sharded_mask(cfg, tp)


def state_axis(key: str, axes: Dict[str, Optional[int]]) -> Optional[int]:
    """The split axis of an optimizer-state leaf (flat key ``key``),
    from its parameter's: moments (``m/…``, ``v/…``) follow their
    parameter; adafactor's ``vr`` (the last dim reduced) and ``vc`` (the
    second to last reduced) keep the entries that survive; scalars and
    vector accumulators are replicated."""
    slot, _, rest = key.partition("/")
    if slot in ("m", "v") and rest in axes:
        return axes[rest]
    if slot == "acc":
        pkey, _, trail = rest.rpartition("/")
        ax = axes.get(pkey)
        if ax is None or trail == "v":
            return None
        if trail == "vr":
            return None if ax == -1 else ax + 1
        if trail == "vc":
            return None if ax == -2 else (-1 if ax == -1 else ax + 1)
    return None


# ----------------------------------------------------------------------
# FSDP: the "data" entries of the per-leaf rule
# ----------------------------------------------------------------------
def fsdp_split(name: str, shape, sizes: Dict[str, int], *,
               mode: str = "2d", moe_ep_axis: str = "model"
               ) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """``(dim, axes)``: the dim (negative) that leaf ``name`` of full
    ``shape`` stores split over the mesh ``axes`` (sizes by name in
    ``sizes``), or None when FSDP leaves it whole.

    The FSDP entry of the reference's ``_param_rule``: column-parallel
    leaves, the embedding table and the head on dim −2, row-parallel
    ones on −1, the experts on −2, or on their expert dim −3 when they
    ride "data" (``moe_ep_axis``; TP then leaves them whole); 1-D
    vectors and conv channels never.  ``mode="2d"`` puts it on "data";
    ``"dp_only"`` (no TP) on ("data", "model") together.  Then
    ``fit_spec``'s rule: each axis in turn is kept where the dim divides
    the product so far (an axis of one rank splits nothing and is
    dropped too), so a dim that no count divides stays whole."""
    nd = len(shape)
    dim = None
    if name in _EXPERT and nd >= 3:
        dim = -3 if mode == "2d" and moe_ep_axis == "data" else -2
    elif name in _COL_PARALLEL and nd >= 2:
        dim = -2
    elif name in _ROW_PARALLEL and nd >= 2:
        dim = -1
    elif name in ("table", "w") and nd >= 2:
        dim = -2
    if dim is None:
        return None
    keep, size = [], 1
    for a in ("data",) if mode == "2d" else ("data", "model"):
        n = sizes.get(a, 1)
        if n > 1 and shape[dim] % (size * n) == 0:
            keep.append(a)
            size *= n
    return (dim, tuple(keep)) if keep else None


def fsdp_splits(cfg, sizes: Dict[str, int], *, mode: str = "2d",
                moe_ep_axis: str = "model"
                ) -> Dict[str, Optional[Tuple[int, Tuple[str, ...]]]]:
    """:func:`fsdp_split` of every param leaf of ``cfg`` by flat key."""
    return {k: fsdp_split(k.rsplit("/", 1)[-1], v, sizes, mode=mode,
                          moe_ep_axis=moe_ep_axis)
            for k, v in _full_shapes(cfg).items()}


def data_axes(cfg, data: int) -> Dict[str, Optional[int]]:
    """The dim (negative) each param leaf of ``cfg`` stores split over
    ``data`` "data" ranks (the coded step's FSDP), by flat key; None:
    whole."""
    return {k: (s[0] if s else None)
            for k, s in fsdp_splits(cfg, {"data": data}).items()}


def fsdp_block(x: torch.Tensor, axis: Optional[int], c: ShardCtx
               ) -> torch.Tensor:
    """This rank's block of ``x`` on ``axis`` over ``c``'s ranks (a
    view); ``x`` itself when it is not split."""
    if axis is None or not c.active:
        return x
    n = x.shape[axis] // c.tp
    return x.narrow(axis % x.ndim, c.rank * n, n)


def fsdp_gather(leaves: Sequence[torch.Tensor],
                splits: Sequence[Optional[Tuple[int, ShardCtx]]]
                ) -> List[torch.Tensor]:
    """The whole leaves of FSDP-stored ``leaves``: a split one gathered
    over its ranks (``(axis, ctx)``, the all-gather of the members'
    blocks: a new tensor, marked to require a gradient like the stored
    one), a whole one itself."""
    out = []
    for p, sp in zip(leaves, splits):
        if sp is None or not sp[1].active:
            out.append(p)
            continue
        whole = sp[1].gather(p.detach(), sp[0])
        out.append(whole.requires_grad_(p.requires_grad))
    return out


# ----------------------------------------------------------------------
# pipeline parallelism: the "stage" axis
# ----------------------------------------------------------------------
def stage_layer_ranges(cfg, pp: int) -> Tuple[Tuple[int, int], ...]:
    """Per-stage ``(first_layer, one_past_last)`` under pp stages.

    Stages split the stacked layer groups contiguously — stage s owns
    groups ``[s·G/pp, (s+1)·G/pp)`` with ``G = n_layers // P`` for a
    block pattern of period P, i.e. ``P·G/pp`` consecutive layers.  The
    remainder layers (``n_layers % P``), the final norm and the unembed
    head ride the LAST stage; the embedding sits on the first (every
    stage holds a replicated copy).
    """
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    gps = n_groups // max(pp, 1)
    ranges = [(s * gps * period, (s + 1) * gps * period) for s in range(pp)]
    lo, hi = ranges[-1]
    ranges[-1] = (lo, hi + cfg.n_layers % period)
    return tuple(ranges)


def validate_pp(cfg, pp: int, *, microbatches: int = 0,
                batch_rows: int = 0) -> None:
    """Clear error (instead of a shape crash) for a bad ``--pp`` degree.

    Pipeline stages split the stacked layer-group dim, so the group count
    ``n_layers // len(block_pattern)`` must divide evenly.
    ``microbatches``/``batch_rows`` (when given) check that the per-group
    coded batch splits into whole microbatches.  The reference's checks,
    with its messages.
    """
    if pp <= 1:
        return
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    errs = []
    if n_groups % pp:
        errs.append(
            f"n_layers={cfg.n_layers} with block pattern period "
            f"{period} gives {n_groups} scanned layer groups, not "
            f"divisible by pp={pp} — each stage must own an equal "
            f"contiguous group block"
        )
    if microbatches > 0 and batch_rows > 0 and batch_rows % microbatches:
        errs.append(
            f"per-group batch of {batch_rows} rows not divisible by "
            f"microbatches={microbatches}"
        )
    if errs:
        raise ValueError(
            f"{cfg.name}: pipeline parallelism pp={pp} violates "
            f"divisibility constraints: " + "; ".join(errs)
        )


def stage_axes(cfg, pp: int) -> Dict[str, Optional[int]]:
    """The axis (negative) each param leaf of ``cfg`` is split on over
    ``pp`` stages, by flat key: a ``groups`` stack on its leading
    (stacked-group) axis, ``-ndim``; every other leaf (the embedding, the
    head, the final norm, the ``rest`` layers, whisper's ``encoder``)
    None, replicated.  Negative, so an EF residual's leading pods axis
    and an optimizer state's reduced trailing dims leave it right
    (:func:`state_axis` maps it as it maps a "model" axis)."""
    return {k: (-len(v) if pp > 1 and k.startswith("groups/") else None)
            for k, v in _full_shapes(cfg).items()}


def stage_sharded_mask(cfg, pp: int) -> Dict[str, bool]:
    """True per flat key iff the leaf is split over the "stage" axis.

    The pipelined step's gradient correction keys off this: a stage's
    gradient of a split leaf (its block of the group stacks) is exact,
    and a replicated leaf's holds only that stage's paths (stage 0's
    embedding, the last stage's head and rest layers, each stage's
    cross-attention uses of whisper's encoder), so it is summed over
    "stage".
    """
    return {k: ax is not None for k, ax in stage_axes(cfg, pp).items()}
