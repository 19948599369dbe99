"""Two-stage coded gradient aggregation over the (pod, data) mesh.

PyTorch counterpart of ``repro.dist.grad_sync``: the decode pipeline of
the paper, pod = edge and data = worker:

  worker encode (eq. 22)  G_ij = Σ_k d^i_jk b_ik g_k   — the weighted
      loss of ``launch.steps`` already yields G_ij as the group gradient;
  edge decode (eq. 25)    G_i  = Σ_{j∈F_i} c^i_j G_ij  — sum over "data";
  master decode (eq. 27)  g    = Σ_{i∈F} a_i G_i       — sum over "pod".

λ_ij = a_i·c^i_j is a runtime operand (:func:`lam_array_from_code`): a
straggler drop changes only that array.  The bandwidth-limited
edge→master hop optionally rides :mod:`repro_torch.dist.compression`,
decoded by the fused dequant combine kernels; the bulk encode/decode of
the code rides the ``coded_combine`` kernel (``kernels.ops``).

The collectives are those of :class:`repro_torch.dist.mesh.OneCardMesh`
or, across ranks, :class:`repro_torch.dist.mesh.DistMesh`: each process
decodes its own pods, then the pod collective finishes the sum.  Under
tensor parallelism the gradient leaves, and the EF residuals that
telescope against them, are this rank's shards; under pipeline
parallelism they are a stage's leaves (its block of the layer-group
stacks, and the replicated leaves, which ``pod_correct`` sums over
"stage" once per pod partial, before the hop quantizes it).  Gradients
are lists of leaves in :func:`repro_torch._tree.leaves` order.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.dist import compression
from repro_torch.dist.mesh import GroupFn
from repro_torch.kernels import ops as kernel_ops


def lam_array_from_code(code, fast_edges: Sequence[int],
                        fast_workers: Sequence[Sequence[int]], pods: int,
                        data: int, dtype=np.float32) -> np.ndarray:
    """Collapsed per-worker decode weights λ_ij as a (pods, data) array
    (``HGCCode.collapsed_weights`` on the mesh; stragglers 0)."""
    if (code.topo.n, code.topo.m) != (pods, (data,) * pods):
        raise ValueError(f"code topology {code.topo.m} does not match the "
                         f"({pods}×{data}) mesh")
    lam = code.collapsed_weights(fast_edges, fast_workers)
    return np.asarray(lam, dtype).reshape(pods, data)


#: a linear map of a pod's partial (leaf list → leaf list), applied
#: after the data sum: the pipeline's stage sum of replicated leaves
PodCorrect = Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]]


def coded_weighted_psum(mesh, group_fn: GroupFn, lam,
                        pod_correct: PodCorrect = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """λ-weighted hierarchical sum of every group's gradient.

    Stage 1 sums λ-weighted messages over each pod's workers (edge
    decode, eq. 25), then ``pod_correct`` (if given) maps the pod's
    partial; stage 2 sums the per-edge partials over pods (master
    decode, eq. 27).  Stragglers take part with λ = 0.  Returns
    ``(decoded leaves, Σ_ij λ_ij · loss_ij)``.
    """
    total, loss = None, None
    for pod in mesh.pod_indices():
        part, loss_i = mesh.psum_data(pod, group_fn, lam)  # eq. 25
        if pod_correct is not None:
            part = pod_correct(part)
        total = mesh.psum_pod(total, part)                   # eq. 27
        loss = loss_i if loss is None else loss + loss_i
    *total, loss = mesh.reduce_pods(total + [loss])
    return total, loss


def _encode_hop(partial: torch.Tensor, residual: torch.Tensor, block: int,
                mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payload, scales)`` of ``partial + residual`` (both consumed:
    the sum is formed in ``partial``); ``residual`` becomes what the
    payload failed to carry — the EF update needs exactly what the wire
    carries."""
    target = partial.add_(residual)
    q, s, meta = compression.quantize(target, block=block, mode=mode)
    torch.sub(target, compression.dequantize(q, s, meta), out=residual)
    return q, s


def compressed_coded_psum(mesh, group_fn: GroupFn, lam,
                          residual: List[torch.Tensor], *, block: int = 64,
                          mode: str = "int8", pod_correct: PodCorrect = None
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """λ-weighted decode with a quantized + error-feedback cross-pod hop.

    Stage 1 (eq. 25) stays exact; ``pod_correct``, if given, maps each
    pod's partial before it is quantized.  Each pod's partial plus its
    EF residual is then blockwise quantized (``mode`` ∈ int8 | int4 | fp8),
    each pod's payload is gathered into its row of ``(n_pods, payload)``
    and combined through the matching fused dequant kernel with unit
    coefficients (eq. 27 over quantized payloads).  ``residual`` leaves
    are ``(rows, *leaf.shape)`` float32, one row for each pod of
    ``mesh.residual_rows()`` (every pod's, or a pod rank's own), and are
    updated in place to what the payload failed to carry (EF-SGD:
    transmitted values telescope).  A process encodes only its own pods'
    partials; the all-gather fills the other rows of the payload.  Returns ``(decoded leaves, Σ_ij λ_ij · loss_ij)``.
    """
    qbuf: List[torch.Tensor] = []  # per leaf (n_pods, payload)
    sbuf: List[torch.Tensor] = []  # per leaf (n_pods, n_blocks)
    shapes: Optional[List[torch.Size]] = None
    loss = None
    for pod in mesh.pod_indices():
        part, loss_i = mesh.psum_data(pod, group_fn, lam)  # exact eq. 25
        if pod_correct is not None:
            part = pod_correct(part)
        loss = loss_i if loss is None else loss + loss_i
        if len(part) != len(residual):
            raise ValueError(f"residual has {len(residual)} leaves, "
                             f"gradients {len(part)}")
        shapes = [y.shape for y in part]
        with obs.span("coded.hop"):  # this pod's encode and gather
            for n, r in enumerate(residual):
                q, s = _encode_hop(part[n], r[mesh.residual_row(pod)], block,
                                   mode)
                part[n] = None  # one pod's f32 partial alive at a time
                if len(qbuf) == n:
                    qbuf.append(q.new_empty((mesh.pods,) + tuple(q.shape)))
                    sbuf.append(s.new_empty((mesh.pods,) + tuple(s.shape)))
                mesh.all_gather_pod(qbuf[n], pod, q)
                mesh.all_gather_pod(sbuf[n], pod, s)
    with obs.span("coded.hop"):  # the combine over pods (eq. 27)
        loss, = mesh.reduce_pods([loss])
        ones = torch.ones((1, mesh.pods), dtype=torch.float32,
                          device=residual[0].device)
        decoded = []
        for n, shape in enumerate(shapes):
            out = kernel_ops.combine_compressed(mode, ones, qbuf[n], sbuf[n],
                                                block=block)[0]
            qbuf[n] = sbuf[n] = None
            numel = int(np.prod(shape)) if len(shape) else 1
            decoded.append(out[:numel].reshape(shape))
    return decoded, loss


# ----------------------------------------------------------------------
# bulk encode/decode (the coded_combine kernel)
# ----------------------------------------------------------------------
def encode_messages(code, g_parts: torch.Tensor) -> torch.Tensor:
    """All workers' encoded messages (Σm_i, F) in one kernel launch."""
    return kernel_ops.encode_messages(code, g_parts)


def decode_gradient(code, messages: torch.Tensor, fast_edges,
                    fast_workers) -> torch.Tensor:
    """Decoded full gradient from worker messages via the λ weights."""
    return kernel_ops.decode_gradient(code, messages, fast_edges,
                                      fast_workers)
