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
float32 partial is alive at a time.  A ``torch.distributed`` mesh over
several cards implements the same three calls (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

#: one group's local step: ``(pod, data) → (gradient leaves, loss)``
GroupFn = Callable[[int, int], Tuple[List[torch.Tensor], torch.Tensor]]


class OneCardMesh:
    """``pods × data`` coded groups on one device, run in turn (on the
    device of the batch the step is given)."""

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
        for j in range(self.data):
            lam_ij = float(lam[pod, j])
            grads, loss_ij = group_fn(pod, j)
            if lam_ij != 1.0:  # unit weights (the MoE objective): no pass
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

    @staticmethod
    def all_gather_pod(out: torch.Tensor, pod: int,
                       local: torch.Tensor) -> None:
        """Pod ``pod``'s tensor into row ``pod`` of ``out``, the
        ``(n_pods, *local.shape)`` gathered operand."""
        out[pod].copy_(local)

    @staticmethod
    def psum_pod(total: Optional[List[torch.Tensor]],
                 part: List[torch.Tensor]) -> List[torch.Tensor]:
        """Stage 2 (eq. 27), one pod at a time: ``part`` folded into the
        running sum over pods (``part`` itself when it is the first)."""
        if total is None:
            return part
        for acc, x in zip(total, part):
            acc.add_(x)
        return total
