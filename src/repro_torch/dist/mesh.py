"""The (pod, data) mesh of the coded train step, on one card.

The reference runs the step as a ``shard_map`` over a (pod, data) device
mesh ("pod" = edge, "data" = worker within an edge), with the two-stage
decode as collectives: a ``psum`` over "data" (eq. 25), then a ``psum``
or, on the compressed hop, an ``all_gather`` over "pod" (eq. 27).

:class:`OneCardMesh` runs the same program with every (pod, data) group
on one device, in turn.  Each collective becomes what it computes there:

  * ``psum_data`` — the data axis is a loop over pod i's groups that
    accumulates ``λ_ij · g_ij`` into the pod's partial;
  * ``all_gather_pod`` — each pod's payload written into its row of a
    preallocated ``(n_pods, …)`` buffer, the ``(K, F)`` operand of the
    combine kernels (``all_gather_into_tensor`` across cards);
  * ``psum_pod`` — the pods' partials summed.

The decode loops over pods outermost (``grad_sync``), so only one pod's
float32 partial is alive at a time.

:class:`DistMesh` is the same mesh over the ranks of a
``torch.distributed`` world, with a "model" axis of ``tp`` ranks for
tensor parallelism (``dist.sharding``): ``world = pod_ranks ×
data_ranks × tp`` with ``pod_ranks ∈ {1, pods}`` and ``data_ranks ∈
{1, data}``.  Each rank runs, in turn, the (pod, data) groups at its
coordinates, and a call becomes a collective where its axis spans
ranks: ``psum_data`` the local loop, then an ``all_reduce`` over the
data group; ``all_gather_pod`` an all-gather over the pod group;
``psum_pod`` an ``all_reduce`` over it.  With ``pod_ranks = pods`` and
``data_ranks = data`` each group has ranks of its own (the reference's
layout); with both 1 only "model" spans ranks (the layout of one card
shared by the ranks).  A leading "stage" axis of ``pp`` ranks runs
pipeline parallelism: ``world = stages × pod_ranks × data_ranks × tp``,
stage first, as the reference's mesh orders its axes; each stage holds
its block of the layer-group stacks, hands activations to the next
stage over a two-rank group, and sums over its stage group.

A mesh may span a subset of the world (``ranks``): after
``CodedSession.shrink`` the survivors of a dead pod or worker run on,
and its ranks retire.  Rank and group numbers are then counted within
the subset (:func:`survivors`, :func:`subset_group`).

Where the data ranks are ranks of their own (``data_ranks = data > 1``)
``data_ctx`` is the :class:`~repro_torch.dist.sharding.ShardCtx` over a
rank's data group (span ``fsdp.collective``): FSDP stores the params
split over it.  Where the pods are (``pod_ranks = pods``) a rank holds
only its own pod's EF residual row (:meth:`residual_rows`), as the
reference's ``P("pod", …)`` layout does; :meth:`gather_pod_rows` brings
every pod's together.  :meth:`DistMesh.counting` builds one rank's mesh
over counting groups (``dist.sharding.CountingGroup``) with no world:
the dry run of a rank's coded step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.dist.sharding import (
    FSDP_SPAN,
    NULL_CTX,
    PP_SPAN,
    CollectiveTally,
    CountingGroup,
    ShardCtx,
    all_reduce,
    gather_rows,
    recv_from,
    send_to,
)

#: one group's local step: ``(pod, data) → (gradient leaves, loss)``
GroupFn = Callable[[int, int], Tuple[List[torch.Tensor], torch.Tensor]]


class OneCardMesh:
    """``pods × data`` coded groups on one device, run in turn (on the
    device of the batch the step is given).  One stage: ``pp`` 1."""

    pp, stage = 1, 0
    stage_ctx = data_ctx = NULL_CTX

    def __init__(self, pods: int, data: int):
        if pods < 1 or data < 1:
            raise ValueError(f"bad mesh ({pods} x {data})")
        self.pods, self.data = int(pods), int(data)

    def group_rows(self, pod: int, data: int, n_rows: int) -> slice:
        """The batch rows of group (pod, data): the batch dim is sharded
        over ("pod", "data") in that order, as ``P(("pod", "data"))``."""
        n = self.pods * self.data
        if n_rows % n:
            raise ValueError(f"{n_rows} batch rows do not split over "
                             f"{n} groups")
        per = n_rows // n
        g = pod * self.data + data
        return slice(g * per, (g + 1) * per)

    def psum_data(self, pod: int, group_fn: GroupFn, lam
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Stage 1 (eq. 25) for pod ``pod``: ``Σ_j λ_ij · g_ij`` over its
        groups, each computed by ``group_fn(pod, j)`` and folded into the
        partial as soon as it exists; with it ``Σ_j λ_ij · loss_ij``.
        ``lam`` is the (pods, data) λ array."""
        lam = np.asarray(lam, np.float32)
        partial: Optional[List[torch.Tensor]] = None
        loss = None
        for j in self.data_indices():
            lam_ij = float(lam[pod, j])
            grads, loss_ij = group_fn(pod, j)
            with obs.span("coded.edge_decode"):
                if lam_ij != 1.0:  # unit weights (MoE objective): no pass
                    for g in grads:
                        g.mul_(lam_ij)
                if partial is None:
                    partial = list(grads)
                    loss = loss_ij * lam_ij
                else:
                    for acc, g in zip(partial, grads):
                        acc.add_(g)
                    loss = loss + loss_ij * lam_ij
            del grads
        return partial, loss

    def pod_indices(self) -> Sequence[int]:
        """The pods whose groups this process runs: all of them."""
        return range(self.pods)

    def data_indices(self) -> Sequence[int]:
        """The data indices of a pod that this process runs: all."""
        return range(self.data)

    def all_gather_pod(self, out: torch.Tensor, pod: int,
                       local: torch.Tensor) -> None:
        """Pod ``pod``'s tensor into row ``pod`` of ``out``, the
        ``(n_pods, *local.shape)`` gathered operand."""
        out[pod].copy_(local)

    @staticmethod
    def psum_pod(total: Optional[List[torch.Tensor]],
                 part: List[torch.Tensor]) -> List[torch.Tensor]:
        """Stage 2 (eq. 27), one pod at a time: ``part`` folded into the
        running sum over this process's pods (``part`` itself when it is
        the first); :meth:`reduce_pods` finishes the sum."""
        if total is None:
            return part
        for acc, x in zip(total, part):
            acc.add_(x)
        return total

    def reduce_pods(self, tensors: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Sums over pods held by other processes: none here."""
        return tensors

    def residual_rows(self) -> Sequence[int]:
        """The pods whose EF residual rows this process holds, in row
        order: all of them."""
        return range(self.pods)

    def residual_row(self, pod: int) -> int:
        """Pod ``pod``'s row in this process's residual leaves."""
        return list(self.residual_rows()).index(pod)

    def gather_pod_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The ``(n_pods, …)`` array of every pod's EF residual row, from
        this process's rows: here they are all of them."""
        return rows


#: process groups by (world, member ranks), made once per world
_GROUPS: Dict[Tuple, object] = {}


def _group(ranks: Sequence[int]):
    """The process group of ``ranks`` (global), made once per world."""
    key = (id(dist.group.WORLD), tuple(ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def _axis_groups(rank_lists: List[List[int]], make=_group
                 ) -> Dict[int, object]:
    """One process group per member list (``make(ranks)``), made by every
    rank of the mesh in the same order (``new_group`` names a group by a
    per-process count) → rank → its group."""
    out = {}
    for ranks in rank_lists:
        g = make(ranks)
        for r in ranks:
            out[r] = g
    return out


def subset_group(ranks: Sequence[int]):
    """The group of the ranks that take part in a mesh (None: the whole
    world).  Every rank of the world calls it with the same ``ranks``,
    members or not (``new_group``'s contract); a non-member gets a
    handle it never uses."""
    ranks = tuple(ranks)
    if len(ranks) == dist.get_world_size():
        return None
    return _group(ranks)


def survivors(mesh: "DistMesh", dead_edges=(), dead_workers=()
              ) -> Tuple[int, ...]:
    """The global ranks of ``mesh`` that hold a surviving (pod, data)
    group: ``dead_edges`` and ``dead_workers`` ((edge, worker) pairs) in
    the current numbering, as ``CodedCluster.shrink`` takes them.  Every
    rank of a layout that runs all groups on each rank survives; the
    "stage" and "model" axes are kept whole."""
    dead_e = set(dead_edges)
    dead_w = {tuple(p) for p in dead_workers}
    keep = []
    for v, rank in enumerate(mesh.ranks):
        d = (v // mesh.tp) % mesh.data_ranks
        p = (v // (mesh.tp * mesh.data_ranks)) % mesh.pod_ranks
        if mesh.pod_ranks > 1 and p in dead_e:
            continue
        if mesh.data_ranks > 1 and (p, d) in dead_w:
            continue
        keep.append(rank)
    return tuple(keep)


class DistMesh(OneCardMesh):
    """The (pod, data) mesh, a "model" axis and a leading "stage" axis
    over the ranks of the current ``torch.distributed`` world.

    Rank ``ranks[((s · pod_ranks + p) · data_ranks + d) · tp + m]``
    holds stage ``s``, pod coordinate ``p``, data coordinate ``d`` and
    model index ``m``; it runs the groups :meth:`pod_indices` ×
    :meth:`data_indices`.  ``ranks`` (global, ascending; default the
    whole world) are the ranks that take part: ``group`` is theirs
    (None for the whole world), and every rank of the world has made it
    (:func:`subset_group`) before the members build the mesh.
    ``ctx`` is the :class:`~repro_torch.dist.sharding.ShardCtx` of its
    model group, ``stage_ctx`` the same over its stage group (span
    ``pp.collective``); :meth:`send_next` / :meth:`recv_prev` (and their
    backward twins) hand a tensor to the adjacent stage of the same
    (pod, data, model) coordinates.  At ``stages`` 1 every rank number
    and group is the pipeline-free mesh's.
    """

    def __init__(self, pods: int, data: int, tp: int = 1, *,
                 pod_ranks: int = 1, data_ranks: int = 1, stages: int = 1,
                 ranks: Optional[Sequence[int]] = None, _counting=None):
        super().__init__(pods, data)
        if (pod_ranks, data_ranks) not in ((1, 1), (self.pods, self.data)) \
                or tp < 1 or stages < 1:
            raise ValueError(
                f"mesh ranks (pod {pod_ranks}, data {data_ranks}, model "
                f"{tp}) for ({self.pods} x {self.data}) groups: (pod, "
                f"data) ranks must be (1, 1) or ({self.pods}, {self.data})")
        world = stages * pod_ranks * data_ranks * tp
        make = _group
        if _counting is not None:  # the dry run: no world
            rank, tally, link = _counting
            ranks = tuple(range(world))

            def make(rs):
                return CountingGroup(len(rs), tuple(rs), link, tally)

            self.group, self.global_rank = make(ranks), ranks[rank]
        else:
            have = dist.get_world_size() if dist.is_initialized() else 1
            ranks = tuple(range(have) if ranks is None else ranks)
            if not dist.is_initialized() or len(ranks) != world:
                raise ValueError(
                    f"mesh of " + (f"{stages} x " if stages > 1 else "")
                    + f"{pod_ranks} x {data_ranks} x {tp} ranks needs a "
                    f"world of {world}, this one has {len(ranks)}")
            self.group = subset_group(ranks)
            self.global_rank = dist.get_rank()
        self.tp, self.pod_ranks, self.data_ranks = tp, pod_ranks, data_ranks
        self.pp = stages
        self.ranks = ranks
        v = ranks.index(self.global_rank)  # this rank within the mesh
        self.model_rank = v % tp
        self.data_rank = (v // tp) % data_ranks
        self.pod_rank = (v // (tp * data_ranks)) % pod_ranks
        self.stage = v // (tp * data_ranks * pod_ranks)
        S, P, D, M = (range(stages), range(pod_ranks), range(data_ranks),
                      range(tp))
        rank = self.global_rank

        def at(s, p, d, m):
            return ranks[((s * pod_ranks + p) * data_ranks + d) * tp + m]

        model = _axis_groups([[at(s, p, d, m) for m in M] for s in S
                              for p in P for d in D], make) if tp > 1 else {}
        self._data_group = _axis_groups(
            [[at(s, p, d, m) for d in D] for s in S for p in P for m in M],
            make).get(rank) if data_ranks > 1 else None
        self._pod_group = _axis_groups(
            [[at(s, p, d, m) for p in P] for s in S for d in D for m in M],
            make).get(rank) if pod_ranks > 1 else None
        self.ctx = ShardCtx(tp=tp, rank=self.model_rank,
                            group=model.get(rank))
        self.data_ctx = NULL_CTX
        if data_ranks > 1:
            self.data_ctx = ShardCtx(tp=data_ranks, rank=self.data_rank,
                                     group=self._data_group, span=FSDP_SPAN)
        self.stage_ctx = NULL_CTX
        self._prev = self._next = None  # (peer rank, pair group)
        if stages > 1:
            coords = [(p, d, m) for p in P for d in D for m in M]
            stage = _axis_groups([[at(s, *c) for s in S] for c in coords],
                                 make)
            self.stage_ctx = ShardCtx(tp=stages, rank=self.stage,
                                      group=stage[rank], span=PP_SPAN)
            # every rank makes the pair groups in one order: stage pair
            # (s, s + 1) at each (pod, data, model) coordinate
            for s in range(stages - 1):
                pairs = _axis_groups([[at(s, *c), at(s + 1, *c)]
                                      for c in coords], make)
                step = tp * data_ranks * pod_ranks
                if self.stage == s:
                    self._next = (ranks[v + step], pairs[rank])
                elif self.stage == s + 1:
                    self._prev = (ranks[v - step], pairs[rank])

    @classmethod
    def for_world(cls, pods: int, data: int, tp: int, pp: int = 1,
                  ranks: Optional[Sequence[int]] = None) -> "DistMesh":
        """The layout the world's size implies (the size of ``ranks``,
        when given: the ranks that take part): ``world / (pp · tp)``
        ranks over (pod, data) are 1 (every group in turn on each rank)
        or ``pods × data`` (a group each)."""
        world = len(ranks) if ranks is not None else (
            dist.get_world_size() if dist.is_initialized() else 1)
        if world % (tp * pp):
            raise ValueError(f"a world of {world} ranks does not split "
                             f"into tp={tp}" + (f" x pp={pp}" if pp > 1
                                                 else ""))
        n = world // (tp * pp)
        for pr, dr in ((1, 1), (pods, data)):
            if pr * dr == n:
                return cls(pods, data, tp, pod_ranks=pr, data_ranks=dr,
                           stages=pp, ranks=ranks)
        raise ValueError(
            f"a world of {world} ranks at tp={tp}"
            + (f", pp={pp}" if pp > 1 else "")
            + f" leaves {n} ranks for ({pods} x {data}) groups: 1 or "
            f"{pods * data} fit")

    @classmethod
    def counting(cls, pods: int, data: int, tp: int = 1, *,
                 pod_ranks: int = 1, data_ranks: int = 1, stages: int = 1,
                 rank: int = 0, tally: Optional[CollectiveTally] = None,
                 link: float = 0.0) -> "DistMesh":
        """Rank ``rank``'s mesh over counting groups in ``tally``, each on
        a link of ``link`` bytes/s (no world: the dry run of one rank's
        coded step on the ``meta`` device)."""
        return cls(pods, data, tp, pod_ranks=pod_ranks,
                   data_ranks=data_ranks, stages=stages,
                   _counting=(rank, tally or CollectiveTally(), link))

    # ---- the stage handoff (pipeline parallelism) --------------------
    def send_next(self, x: torch.Tensor) -> None:
        """``x`` to the next stage (this rank's forward output)."""
        send_to(x, self.global_rank, *self._next)

    def recv_prev(self, buf: torch.Tensor) -> torch.Tensor:
        """The previous stage's forward output into ``buf``."""
        return recv_from(buf, *self._prev)

    def send_prev(self, g: torch.Tensor) -> None:
        """A cotangent back to the previous stage."""
        send_to(g, self.global_rank, *self._prev)

    def recv_next(self, buf: torch.Tensor) -> torch.Tensor:
        """The next stage's cotangent of this rank's output into ``buf``."""
        return recv_from(buf, *self._next)

    def pod_indices(self) -> Sequence[int]:
        return range(self.pods) if self.pod_ranks == 1 else [self.pod_rank]

    def data_indices(self) -> Sequence[int]:
        return (range(self.data) if self.data_ranks == 1
                else [self.data_rank])

    def psum_data(self, pod, group_fn, lam):
        partial, loss = super().psum_data(pod, group_fn, lam)
        if self._data_group is not None:
            with obs.span("coded.edge_decode"):
                partial = [all_reduce(g, self._data_group) for g in partial]
                loss = all_reduce(loss, self._data_group)
        return partial, loss

    def all_gather_pod(self, out, pod, local):
        if self._pod_group is None:
            out[pod].copy_(local)
        else:
            gather_rows(out, pod, local, self._pod_group)

    def reduce_pods(self, tensors):
        if self._pod_group is None:
            return tensors
        return [all_reduce(t, self._pod_group) for t in tensors]

    def residual_rows(self):
        return range(self.pods) if self.pod_ranks == 1 else [self.pod_rank]

    def gather_pod_rows(self, rows):
        if self._pod_group is None:
            return rows
        out = rows.new_empty((self.pods,) + tuple(rows.shape[1:]))
        gather_rows(out, self.pod_rank, rows[0], self._pod_group)
        return out
