"""The seven comparison schemes of paper §V-A.

The port's copy of ``repro.core.schemes`` (numpy; imports renamed),
plus each scheme's ``decode_weights``.  Every scheme exposes the same
protocol, consumed by the simulator (`repro_torch.sim`):

  * ``load``               — per-worker computational load D,
  * ``iteration(sample)``  — iteration time + the (edges, workers) that
                             were actually waited for, per the scheme's
                             waiting rule (eqs 31–33),
  * ``gradient(g_parts, fast)`` — the aggregated gradient the master
                             obtains (exact for all coded schemes and
                             Uncoded; partial for Greedy),
  * ``decode_weights(fast)`` — the (K,) float64 vector ``a`` with
                             ``gradient(g_parts, fast) == a @ g_parts``:
                             the scheme's decode collapsed into one row
                             of eqs. 25/27,
  * ``master_messages``    — communication load of the master (Fig. 7).

Equivalences used (and verified in tests):
  CGC-W  ≡ HGC(s_e = 0, s_w)   (code workers↔edge, master waits all edges)
  CGC-E  ≡ HGC(s_e, s_w = 0)   (workers uncoded, code edges↔master)
Standard GC is a flat worker↔master code with equal tolerance
  s = max_{|S_e|=s_e} Σ_{i∈S_e} m_i + (n−s_e)·s_w   (eq 8),
workers communicating directly with the master (no edge hop).

``gradient`` keeps the reference's numpy arithmetic for a numpy
``g_parts``; for a (K, F) tensor it is ``a @ g_parts`` through
``kernels.ops.combine``: one coded-combine launch on the card, its plain
version on the CPU.  torch is imported only there, so the module stays
numpy-only on import.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import jncss as jncss_mod
from repro_torch.core import tradeoff
from repro_torch.core.encoding import LinearCode, build_random_code, cyclic_supports
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import ClusterParams, kth_min
from repro_torch.core.topology import Tolerance, Topology

SCHEME_NAMES = (
    "uncoded",
    "greedy",
    "cgc_w",
    "cgc_e",
    "standard_gc",
    "hgc",
    "hgc_jncss",
    "hgc_grouped",
    "hgc_comm",
)


@dataclasses.dataclass
class IterationOutcome:
    time: float
    fast_edges: Tuple[int, ...]
    # per-edge tuple of worker indices waited for ((), if edge unused)
    fast_workers: Tuple[Tuple[int, ...], ...]


def _combine_tensor(a: np.ndarray, g_parts):
    """``a @ g_parts`` for a (K, F) float32 tensor, ``a`` cast once from
    float64: ``kernels.ops.combine`` with one coefficient row."""
    import torch

    from repro_torch.kernels import ops

    coeff = torch.as_tensor(np.asarray(a, np.float32)[None],
                            device=g_parts.device)
    return ops.combine(coeff, g_parts)[0]


class Scheme:
    """Base protocol; see module docstring."""

    name: str
    topo: Topology
    K: int
    exact: bool = True

    @property
    def load(self) -> float:
        raise NotImplementedError

    def iteration(
        self, sample: Tuple[np.ndarray, np.ndarray, np.ndarray]
    ) -> IterationOutcome:
        raise NotImplementedError

    def decode_weights(self, outcome: IterationOutcome) -> np.ndarray:
        raise NotImplementedError

    def gradient(self, g_parts, outcome: IterationOutcome):
        """The master's aggregate: the reference's numpy arithmetic for a
        numpy ``g_parts``, one combine of ``decode_weights`` for a tensor."""
        if isinstance(g_parts, np.ndarray):
            return self._gradient_numpy(g_parts, outcome)
        return _combine_tensor(self.decode_weights(outcome), g_parts)

    def _gradient_numpy(
        self, g_parts: np.ndarray, outcome: IterationOutcome
    ) -> np.ndarray:
        raise NotImplementedError

    @property
    def master_messages(self) -> int:
        raise NotImplementedError


def _hier_iteration(
    topo: Topology,
    sample: Tuple[np.ndarray, np.ndarray, np.ndarray],
    s_e: int,
    s_w,
) -> IterationOutcome:
    """eqs (32)/(33): wait fastest m_i−s_w workers, then fastest n−s_e edges.

    ``s_w`` may be a scalar (uniform) or a per-edge vector (grouped
    tolerance — each edge waits at its own s_w^i).
    """
    wt, eu, _ = sample
    n = topo.n
    s_w_arr = np.asarray(s_w)
    if s_w_arr.ndim == 0:
        s_w_arr = np.full(n, int(s_w_arr))
    edge_T = np.empty(n)
    fast_w: List[Tuple[int, ...]] = []
    off = 0
    for i in range(n):
        mi = topo.m[i]
        wi = wt[off : off + mi]
        k = mi - int(s_w_arr[i])
        order = np.argsort(wi, kind="stable")[:k]
        edge_T[i] = eu[i] + wi[order[-1]]
        fast_w.append(tuple(sorted(order.tolist())))
        off += mi
    k_e = n - s_e
    eorder = np.argsort(edge_T, kind="stable")[:k_e]
    T = float(edge_T[eorder[-1]])
    chosen = set(eorder.tolist())
    fast_workers = tuple(
        fast_w[i] if i in chosen else () for i in range(n)
    )
    return IterationOutcome(
        time=T,
        fast_edges=tuple(sorted(eorder.tolist())),
        fast_workers=fast_workers,
    )


def _round_robin_parts(topo: Topology, K: int) -> List[List[Tuple[int, ...]]]:
    """Disjoint near-equal split of K parts over all workers (D≈K/W)."""
    W = topo.total_workers
    flat: List[List[int]] = [[] for _ in range(W)]
    for k in range(K):
        flat[k % W].append(k)
    out: List[List[Tuple[int, ...]]] = []
    w = 0
    for i in range(topo.n):
        row = []
        for _j in range(topo.m[i]):
            row.append(tuple(flat[w]))
            w += 1
        out.append(row)
    return out


class UncodedScheme(Scheme):
    """D = K/W disjoint parts each; everyone waits for everyone."""

    name = "uncoded"

    def __init__(self, topo: Topology, K: int):
        self.topo, self.K = topo, K
        self.parts = _round_robin_parts(topo, K)

    @property
    def load(self) -> float:
        return self.K / self.topo.total_workers

    def iteration(self, sample) -> IterationOutcome:
        return _hier_iteration(self.topo, sample, s_e=0, s_w=0)

    def decode_weights(self, outcome) -> np.ndarray:
        return np.ones(self.K)

    def _gradient_numpy(self, g_parts, outcome) -> np.ndarray:
        return g_parts.sum(axis=0)

    @property
    def master_messages(self) -> int:
        return self.topo.n


class GreedyScheme(Scheme):
    """Uncoded placement, coded-style waiting: stragglers are *dropped*.

    The aggregate misses the dropped parts (rescaled to full-batch
    magnitude) — unbiased only under IID parts, which is exactly the
    paper's point about non-IID degradation.
    """

    name = "greedy"
    exact = False

    def __init__(self, topo: Topology, K: int, s_e: int, s_w: int):
        Tolerance(s_e, s_w).validate(topo)
        self.topo, self.K, self.s_e, self.s_w = topo, K, s_e, s_w
        self.parts = _round_robin_parts(topo, K)

    @property
    def load(self) -> float:
        return self.K / self.topo.total_workers

    def iteration(self, sample) -> IterationOutcome:
        return _hier_iteration(self.topo, sample, self.s_e, self.s_w)

    def _received(self, outcome) -> List[int]:
        got: List[int] = []
        for i in outcome.fast_edges:
            for j in outcome.fast_workers[i]:
                got.extend(self.parts[i][j])
        return sorted(set(got))

    def decode_weights(self, outcome) -> np.ndarray:
        got = self._received(outcome)
        a = np.zeros(self.K)
        if got:
            a[got] = self.K / len(got)
        return a

    def _gradient_numpy(self, g_parts, outcome) -> np.ndarray:
        got = self._received(outcome)
        if not got:
            return np.zeros_like(g_parts[0])
        return g_parts[got].sum(axis=0) * (self.K / len(got))

    @property
    def master_messages(self) -> int:
        return self.topo.n - self.s_e


class HGCScheme(Scheme):
    """The paper's scheme (§III) at tolerance (s_e, s_w)."""

    name = "hgc"

    def __init__(
        self,
        topo: Topology,
        K: int,
        s_e: int,
        s_w: int,
        seed: int = 0,
        construction: str = "random",
        name: Optional[str] = None,
    ):
        self.topo, self.K = topo, K
        self.code = HGCCode.build(
            topo, Tolerance(s_e, s_w), K=K, seed=seed,
            construction=construction,
        )
        self.s_e, self.s_w = s_e, s_w
        if name:
            self.name = name

    @property
    def load(self) -> float:
        return float(self.code.load)

    def iteration(self, sample) -> IterationOutcome:
        return _hier_iteration(self.topo, sample, self.s_e, self.s_w)

    @functools.cached_property
    def _encoding_matrix(self) -> np.ndarray:
        return self.code.encoding_matrix_flat()

    def decode_weights(self, outcome) -> np.ndarray:
        """λ (``collapsed_weights``) times the (Σm_i × K) effective
        worker coefficients (``encoding_matrix_flat``)."""
        lam = self.code.collapsed_weights(
            outcome.fast_edges, outcome.fast_workers
        )
        return lam @ self._encoding_matrix

    def _gradient_numpy(self, g_parts, outcome) -> np.ndarray:
        lam = self.code.collapsed_weights(
            outcome.fast_edges, outcome.fast_workers
        )
        out = np.zeros_like(g_parts[0], dtype=np.float64)
        for i in outcome.fast_edges:
            for j in outcome.fast_workers[i]:
                w = lam[self.topo.flat_index(i, j)]
                out += w * self.code.worker_encode(i, j, g_parts)
        return out

    @property
    def master_messages(self) -> int:
        return self.topo.n - self.s_e


class GroupedHGCScheme(HGCScheme):
    """Heterogeneity-aware grouped HGC (per-edge worker tolerances).

    Wraps :class:`repro_torch.core.grouping.GroupedHGCCode`; the waiting rule
    applies edge ``i``'s own ``s_w^i``, so on intra-edge-heterogeneous
    clusters the planner can buy tolerance only where it pays.
    """

    def __init__(
        self,
        topo: Topology,
        K: int,
        s_e: int,
        s_w_vec: Sequence[int],
        seed: int = 0,
    ):
        from repro_torch.core.grouping import GroupedHGCCode, GroupTolerance

        self.topo, self.K = topo, K
        gtol = GroupTolerance(s_e, tuple(int(s) for s in s_w_vec))
        self.code = GroupedHGCCode.build(topo, gtol, K=K, seed=seed)
        # self.s_w is the vector: the inherited iteration() passes it to
        # _hier_iteration, which applies it per edge.
        self.s_e, self.s_w = s_e, tuple(gtol.s_w_vec)
        self.name = "hgc_grouped"

    @property
    def load(self) -> float:
        """Bottleneck (max over edges) per-worker load."""
        return float(self.code.load)

    @property
    def load_array(self) -> np.ndarray:
        """Flat per-worker loads (edges may differ)."""
        return self.code.load_array


class CGCWScheme(HGCScheme):
    """Conventional single-layer coding workers↔edges (≡ HGC(0, s_w))."""

    def __init__(self, topo, K, s_w, seed: int = 0):
        super().__init__(topo, K, s_e=0, s_w=s_w, seed=seed, name="cgc_w")

    @property
    def master_messages(self) -> int:
        return self.topo.n


class CGCEScheme(HGCScheme):
    """Conventional single-layer coding edges↔master (≡ HGC(s_e, 0))."""

    def __init__(self, topo, K, s_e, seed: int = 0):
        super().__init__(topo, K, s_e=s_e, s_w=0, seed=seed, name="cgc_e")


class StandardGCScheme(Scheme):
    """Flat worker↔master gradient coding, no edge layer (paper §V-A).

    Equal tolerance rule: s = max_{|S_e|=s_e} Σ m_i + (n−s_e)·s_w.
    """

    name = "standard_gc"

    def __init__(self, topo: Topology, K: int, s_e: int, s_w: int,
                 seed: int = 0):
        self.topo, self.K = topo, K
        worst_edges = sum(sorted(topo.m, reverse=True)[:s_e])
        self.s = worst_edges + (topo.n - s_e) * s_w
        W = topo.total_workers
        if self.s >= W:
            raise ValueError(f"equal tolerance s={self.s} ≥ W={W}")
        if (K * (self.s + 1)) % W != 0:
            raise ValueError(
                f"K={K} incompatible with flat code: W={W}, s={self.s}"
            )
        D = K * (self.s + 1) // W
        sup = cyclic_supports(K, [D] * W)
        self.flat_code = build_random_code(sup, K, self.s, seed=seed)
        self._D = D

    @property
    def load(self) -> float:
        return float(self._D)

    def iteration(self, sample) -> IterationOutcome:
        _, _, wd = sample
        W = self.topo.total_workers
        k = W - self.s
        order = np.argsort(wd, kind="stable")[:k]
        T = float(wd[order[-1]])
        fast = set(order.tolist())
        fast_workers = []
        w = 0
        for i in range(self.topo.n):
            row = []
            for j in range(self.topo.m[i]):
                if w in fast:
                    row.append(j)
                w += 1
            fast_workers.append(tuple(row))
        return IterationOutcome(
            time=T,
            fast_edges=tuple(range(self.topo.n)),
            fast_workers=tuple(fast_workers),
        )

    def decode_weights(self, outcome) -> np.ndarray:
        rows = [
            self.topo.flat_index(i, j)
            for i in outcome.fast_edges
            for j in outcome.fast_workers[i]
        ]
        rows = sorted(rows)[: self.topo.total_workers - self.s]
        a = self.flat_code.full_decode_weights(rows)
        return a @ self.flat_code.matrix

    def _gradient_numpy(self, g_parts, outcome) -> np.ndarray:
        return self.decode_weights(outcome) @ g_parts

    @property
    def master_messages(self) -> int:
        return self.topo.total_workers - self.s


def make_scheme(
    name: str,
    topo: Topology,
    K: int,
    s_e: int = 1,
    s_w: int = 1,
    params: Optional[ClusterParams] = None,
    seed: int = 0,
    construction: str = "random",
    master_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
) -> Scheme:
    """Factory over SCHEME_NAMES.

    ``hgc_jncss``, ``hgc_grouped`` and ``hgc_comm`` require ``params``
    (they plan from the cluster model).  For ``hgc_comm`` the message
    budgets default to ``n − s_e`` (master) and ``max_i m_i − s_w``
    (edge); pass ``master_budget``/``edge_budget`` to set them directly.
    """
    name = name.lower()
    if name == "uncoded":
        return UncodedScheme(topo, K)
    if name == "greedy":
        return GreedyScheme(topo, K, s_e, s_w)
    if name == "cgc_w":
        return CGCWScheme(topo, K, s_w, seed=seed)
    if name == "cgc_e":
        return CGCEScheme(topo, K, s_e, seed=seed)
    if name == "standard_gc":
        return StandardGCScheme(topo, K, s_e, s_w, seed=seed)
    if name == "hgc":
        return HGCScheme(
            topo, K, s_e, s_w, seed=seed, construction=construction
        )
    if name == "hgc_jncss":
        if params is None:
            raise ValueError("hgc_jncss needs ClusterParams for Algorithm 2")
        res = jncss_mod.solve(params, K)
        sch = HGCScheme(
            topo, K, res.s_e, res.s_w, seed=seed, construction=construction,
            name="hgc_jncss",
        )
        sch.jncss_result = res  # attach for reporting
        return sch
    if name == "hgc_grouped":
        if params is None:
            raise ValueError(
                "hgc_grouped needs ClusterParams for the grouped planner"
            )
        from repro_torch.core import grouping

        res = grouping.plan_grouped(params, K, only_compatible=True)
        sch = GroupedHGCScheme(topo, K, res.s_e, res.s_w_vec, seed=seed)
        sch.grouped_result = res  # attach for reporting
        return sch
    if name == "hgc_comm":
        if params is None:
            raise ValueError(
                "hgc_comm needs ClusterParams for the budget solver"
            )
        from repro_torch.core import comm_tradeoff

        if master_budget is None:
            master_budget = topo.n - s_e
        if edge_budget is None:
            edge_budget = max(topo.m) - s_w
        point = comm_tradeoff.solve_comm_budget(
            params, K, max_master_msgs=master_budget,
            max_edge_msgs=edge_budget, integral_K=K,
        )
        sch = HGCScheme(
            topo, K, point.s_e, point.s_w, seed=seed,
            construction=construction, name="hgc_comm",
        )
        sch.comm_point = point  # attach for reporting
        return sch
    raise ValueError(f"unknown scheme {name!r}; choose from {SCHEME_NAMES}")
