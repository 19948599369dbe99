"""The dry run's op counter: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference reads FLOPs, bytes and collectives from the HLO text of a
compiled step, multiplying each loop body by its trip count.  The port
has no compiler and no HLO: it runs one rank's step eagerly on the
``meta`` device (shapes only: no memory, no kernel) under
:class:`OpCounter`, a ``TorchDispatchMode`` that sees every aten op the
step runs, its backward included.  Eager execution runs every loop
(layers, microbatches, KV chunks) as often as the step does, so there
is no trip-count correction to make.  Per op:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for the matmuls and
    convolutions (2·|out|·K for a matmul; an einsum reaches the counter
    as the matmuls it lowers to), one per output element for a
    pointwise op, one per input element for a reduction;
  * bytes accessed: every input and output of each op that is not a
    view, and ``bytes_accessed_bf16eq`` with float32 counted at 2 bytes
    (the reference's bf16-equivalent);
  * live bytes: every storage the step allocates, from its allocation to
    its last reference's death, for the peak (``memory_analysis``).

The kernels are not run on ``meta``: their wrappers
(``kernels.ops``) add the kernel's own work to ``ops.META_WORK``.  The
attention kernels keep the S×T scores on chip; the bytes here count
attention as the plain version moves it (its float32 scores written
and read once, as the reference's HLO counts its score traffic), and
``attn_bytes_bf16eq`` holds those score bytes apart, so
``memory_s_pallas`` in ``api.aot`` is the path with the kernels.

Collectives come from the counting groups' tally
(``dist.sharding.CountingGroup``): :func:`analysis_record` returns the
keys of the reference's ``hlo_analysis.analysis_record``.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.sharding import COLLECTIVES, CollectiveTally
from repro_torch.kernels import ops

#: the softmax family: no pointwise tag, one operation an output element
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}
#: ops that access no bytes: allocations that write nothing, and
#: ``detach_`` (metadata only, and no view by its schema)
_NO_ACCESS = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "detach_"}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bf16eq(t: torch.Tensor) -> int:
    if t.dtype in (torch.float32, torch.float64):
        return 2 * t.numel()
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts what the ops under it do (see the module docstring).

    ``arguments`` (any tree of tensors: params, optimizer state, batch,
    cache) are the step's inputs: their storages are counted once as
    ``argument_bytes`` and never as the step's allocations, so an
    in-place update of one allocates nothing.  The kernels' ``meta``
    work is read from ``ops.META_WORK``, which entering resets."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        self.flops = self.matmul_flops = 0.0
        self.bytes = self.bytes_bf16eq = 0.0
        self._known = {}
        for t in _tensors(arguments):
            st = t.untyped_storage()
            self._known[st._cdata] = st.nbytes()
        self.argument_bytes = float(sum(self._known.values()))
        self._live: Dict[int, int] = {}
        self.live = self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._depth = 0

    def __enter__(self):
        if not self._depth:  # entered again to count a composite's ops
            ops.reset_meta_work()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            self.kernels = {k: dict(v) for k, v in ops.META_WORK.items()}
            self.output_bytes = self.live
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.is_inference_mode_enabled() and \
                func.overloadpacket not in flop_registry:
            # a composite op (``matmul``, ``rms_norm``, ``to``: they reach
            # the mode whole under ``inference_mode``) counted by the ops
            # it runs, as autograd's dispatch shows them otherwise
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._track(out)
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.matmul_flops += f
        elif torch.Tag.pointwise in func.tags or name in _SOFTMAX:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            self.flops += sum(t.numel() for t in ins)
        if name not in _NO_ACCESS:
            moved = ins + outs
            self.bytes += sum(t.numel() * t.element_size() for t in moved)
            self.bytes_bf16eq += sum(_bf16eq(t) for t in moved)
        return out

    # ---- the kernels' own work (kernels.ops, meta route) -------------
    def kernel_total(self, key: str) -> float:
        return sum(w[key] for w in self.kernels.values())

    def memory_analysis(self) -> Dict[str, float]:
        """Argument, output and peak temporary bytes of the step, and
        their sum at the peak: what a card must hold."""
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": float(self.output_bytes),
            "temp_bytes": float(self.peak - self.output_bytes),
            "peak_bytes": self.argument_bytes + float(self.peak),
            "generated_code_bytes": 0.0,
            "alias_bytes": 0.0,
        }


def analysis_record(counter: OpCounter,
                    tally: Optional[CollectiveTally] = None) -> Dict:
    """The reference's ``hlo_analysis.analysis_record`` keys from one
    counted step: ``flops``, ``bytes_accessed``,
    ``bytes_accessed_bf16eq``, ``attn_bytes_bf16eq``, ``collectives``
    (per kind; with ``cross_host_link_bytes`` and ``link_s`` beside the
    reference's), ``collective_operand_bytes``,
    ``collective_link_bytes``, ``collective_link_bytes_bf16eq``,
    ``cross_pod_link_bytes``; and ``matmul_flops`` and the kernels'
    work apart."""
    tally = tally or CollectiveTally()
    scores = counter.kernel_total("scores")
    kernel_bytes = counter.kernel_total("bytes")
    attn_eq = 2 * 2 * scores  # f32 scores written and read, at 2 bytes
    return {
        "flops": counter.flops + counter.kernel_total("flops"),
        "matmul_flops": counter.matmul_flops,
        "bytes_accessed": counter.bytes + kernel_bytes + 2 * 4 * scores,
        "bytes_accessed_bf16eq": counter.bytes_bf16eq + kernel_bytes
        + attn_eq,
        "attn_bytes_bf16eq": attn_eq,
        "kernels": counter.kernels,
        "collectives": {c: dict(tally.by_kind[c]) for c in COLLECTIVES},
        "collective_operand_bytes": tally.total("operand_bytes"),
        "collective_link_bytes": tally.total("link_bytes"),
        "collective_link_bytes_bf16eq": tally.total("link_bytes_bf16eq"),
        "cross_pod_link_bytes": tally.total("cross_pod_link_bytes"),
        "collective_link_s": tally.total("link_s"),
    }
