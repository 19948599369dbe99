"""The production layouts of the dry run.

PyTorch counterpart of ``repro.launch.mesh.make_production_mesh``: the
reference's shapes and axis names, (data 16, model 16) for one pod of
256 cards and (pod 2, data 16, model 16) for two.  The port has no
device mesh to build (the rig has one card), so this is a layout: the
shape, the axis names, the rank :class:`~repro_torch.dist.mesh.DistMesh`
gives each coordinate (the model axis fastest, then data, then pod), and
each axis's counting groups (``dist.sharding.CountingGroup``) for one
rank's view of a step.

Links are H100 SXM hosts of 8 cards: the cards of a host talk over
NVLink at 450 GB/s each way; hosts talk over InfiniBand, and this
module ASSUMES one 400 Gb/s port a card (50 GB/s each way), the usual
DGX H100 build.  A group whose ranks span hosts runs at the slower rate.

:func:`fsdp_layout` gives rank 0's FSDP storage on a layout: each param
leaf's split dim, the counting group of the ranks it is split across
("data", or "data" and "model" under ``mode="dp_only"``) and the group
of the other data-parallel ranks its gradient is summed over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.dist.sharding import (
    FSDP_SPAN,
    HOST_RANKS,
    CollectiveTally,
    CountingGroup,
    ShardCtx,
    fsdp_splits,
)

#: NVLink 4 within a host, bytes/s each way (H100 SXM data sheet)
NVLINK_BW = 450e9
#: InfiniBand between hosts, bytes/s each way a card: an assumption,
#: one 400 Gb/s port a card
IB_BW = 50e9


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A rank layout: ``shape`` by axis name, in ``axis_names`` order,
    the last axis fastest in the rank number."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def rank_of(self, **coords: int) -> int:
        """The rank of a coordinate (missing axes at 0)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords.get(a, 0)
        return r

    def coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return dict(reversed(list(out.items())))

    def group_ranks(self, axes: Tuple[str, ...], rank: int = 0
                    ) -> Tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` but those on
        ``axes``: ``rank``'s group over them."""
        base = self.coords(rank)
        out = [base]
        for a in axes:
            out = [dict(c, **{a: i}) for c in out
                   for i in range(self.shape[a])]
        return tuple(sorted(self.rank_of(**c) for c in out))

    def counting_group(self, ranks: Tuple[int, ...],
                       tally: CollectiveTally) -> CountingGroup:
        """The counting group of ``ranks``: NVLink where they sit on one
        host, the inter-host link where they span hosts."""
        one_host = len({r // HOST_RANKS for r in ranks}) == 1
        return CountingGroup(len(ranks), tuple(ranks),
                             NVLINK_BW if one_host else IB_BW, tally)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """16×16 single pod (256 cards) or 2×16×16 two pods (512 cards)."""
    if multi_pod:
        return ProductionMesh({"pod": 2, "data": 16, "model": 16},
                              ("pod", "data", "model"))
    return ProductionMesh({"data": 16, "model": 16}, ("data", "model"))


def fsdp_layout(mesh: ProductionMesh, cfg, dp_ranks: Tuple[int, ...],
                tally: CollectiveTally, *, mode: str = "2d",
                moe_ep_axis: str = "model") -> Dict:
    """Rank 0's FSDP storage on ``mesh``: flat key → ``(dim, context,
    rest)`` (``dist.sharding.fsdp_split``'s dim; the ``ShardCtx`` over
    the counting group of the ranks the leaf is split across, span
    ``fsdp.collective``; the counting group of the data-parallel ranks
    ``dp_ranks`` that hold the same block, or None when there are none
    but rank 0), or None for a leaf stored whole."""
    sizes = {a: n for a, n in mesh.shape.items() if a != "pod"}
    if mode == "2d":
        sizes.pop("model", None)
    groups: Dict[Tuple[str, ...], Tuple] = {}
    out = {}
    for key, split in fsdp_splits(cfg, sizes, mode=mode,
                                  moe_ep_axis=moe_ep_axis).items():
        if split is None:
            out[key] = None
            continue
        dim, axes = split
        if axes not in groups:
            ranks = mesh.group_ranks(axes)
            rest = tuple(r for r in dp_ranks
                         if all(mesh.coords(r)[a] == 0 for a in axes))
            groups[axes] = (
                ShardCtx(tp=len(ranks), rank=0, span=FSDP_SPAN,
                         group=mesh.counting_group(ranks, tally)),
                mesh.counting_group(rest, tally) if len(rest) > 1
                else None)
        out[key] = (dim,) + groups[axes]
    return out
