"""JNCSS — Jointly Node and Coding Scheme Selection (paper §IV-C).

Algorithm 2 solves  P1: min_{s_e, s_w, e, w} T_tol  exactly (Theorem 2):
for each tolerance pair it evaluates the order-statistic expression

    T̂(s_e, s_w) = min_{(n−s_e)-th} ( A_i + min_{(m_i−s_w)-th} B_(i,j) )

with A_i = τ_i/(1−p_i) and B_(i,j) the expected worker total (eq 43),
then takes the grid minimum.  We provide:

  * :func:`solve`            — vectorized Algorithm 2 (scales to 1000+
                               nodes; the paper's loop form is
                               :func:`solve_reference` for tests),
  * :func:`brute_force`      — exhaustive P2 check used to validate
                               Theorem 2 in the test-suite,
  * :func:`theorem3_gap_bound` — the Theorem 3 a-priori gap bound,
  * :func:`homogeneous_case1` / `homogeneous_case2` — §IV-B closed forms.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tradeoff
from repro_torch.core.runtime_model import ClusterParams, kth_min
from repro_torch.core.topology import Tolerance, Topology


@dataclasses.dataclass(frozen=True)
class JNCSSResult:
    s_e: int
    s_w: int
    T_tol: float
    D: float
    # selection variables (paper eqs 39/40): 1 = participating non-straggler
    e: Tuple[int, ...]
    w: Tuple[Tuple[int, ...], ...]
    # full grid of T̂(s_e, s_w) for diagnostics / benchmarks
    grid: Optional[np.ndarray] = None


def load_D(topo: Topology, K: int, s_e: int, s_w: int) -> float:
    """eq (44): D = K(s_e+1)(s_w+1)/Σ m_i (fractional in the model)."""
    return K * (s_e + 1) * (s_w + 1) / topo.total_workers


def _edge_scores(
    params: ClusterParams, D: float, s_w: int
) -> Tuple[np.ndarray, np.ndarray]:
    """A_i + (m_i−s_w)-th min_j B_(i,j), and the flat B array."""
    topo = params.topo
    B = params.expected_worker_total(D)
    A = params.expected_edge_upload()
    scores = np.empty(topo.n)
    off = 0
    for i in range(topo.n):
        mi = topo.m[i]
        scores[i] = A[i] + kth_min(B[off : off + mi], mi - s_w)
        off += mi
    return scores, B


def solve(
    params: ClusterParams,
    K: int,
    require_feasible: bool = True,
    integral_D: bool = False,
    with_grid: bool = False,
) -> JNCSSResult:
    """Vectorized Algorithm 2 over the full (s_e, s_w) grid."""
    topo = params.topo
    n, m_min = topo.n, topo.m_min
    grid = np.full((n, m_min), np.inf)
    for s_e in range(n):
        for s_w in range(m_min):
            tol = Tolerance(s_e, s_w)
            if require_feasible and not tradeoff.feasible(topo, tol):
                continue
            D = load_D(topo, K, s_e, s_w)
            if integral_D:
                D = float(np.ceil(D))
            scores, _ = _edge_scores(params, D, s_w)
            grid[s_e, s_w] = kth_min(scores, n - s_e)
    if not np.isfinite(grid).any():
        raise ValueError("no feasible (s_e, s_w) for this topology")
    s_e, s_w = np.unravel_index(np.argmin(grid), grid.shape)
    s_e, s_w = int(s_e), int(s_w)
    T = float(grid[s_e, s_w])
    D = load_D(topo, K, s_e, s_w)
    if integral_D:
        D = float(np.ceil(D))
    e, w = _selection(params, D, s_e, s_w, T)
    return JNCSSResult(
        s_e=s_e,
        s_w=s_w,
        T_tol=T,
        D=D,
        e=e,
        w=w,
        grid=grid if with_grid else None,
    )


def _selection(
    params: ClusterParams, D: float, s_e: int, s_w: int, T_hat: float
) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """Algorithm 2 lines 13–21: mark participating nodes/workers."""
    topo = params.topo
    scores, B = _edge_scores(params, D, s_w)
    eps = 1e-12 * max(1.0, abs(T_hat))
    e_sel: List[int] = []
    w_sel: List[Tuple[int, ...]] = []
    n_chosen = 0
    order = np.argsort(scores, kind="stable")
    chosen_edges = set(order[: topo.n - s_e].tolist())
    off = 0
    for i in range(topo.n):
        mi = topo.m[i]
        Bi = B[off : off + mi]
        if i in chosen_edges and scores[i] <= T_hat + eps:
            e_sel.append(1)
            thr = kth_min(Bi, mi - s_w)
            worder = np.argsort(Bi, kind="stable")
            fast = set(worder[: mi - s_w].tolist())
            w_sel.append(tuple(1 if j in fast else 0 for j in range(mi)))
        else:
            e_sel.append(0)
            w_sel.append((0,) * mi)
        off += mi
    return tuple(e_sel), tuple(w_sel)


def solve_reference(params: ClusterParams, K: int) -> JNCSSResult:
    """Direct transliteration of Algorithm 2 (loops, for testing)."""
    topo = params.topo
    best = None
    for s_e in range(topo.n):
        for s_w in range(topo.m_min):
            D = load_D(topo, K, s_e, s_w)
            A = params.expected_edge_upload()
            B = params.expected_worker_total(D)
            per_edge = []
            off = 0
            for i in range(topo.n):
                mi = topo.m[i]
                Bi = sorted(B[off : off + mi])
                per_edge.append(A[i] + Bi[mi - s_w - 1])
                off += mi
            T = sorted(per_edge)[topo.n - s_e - 1]
            if best is None or T < best[0]:
                best = (T, s_e, s_w)
    T, s_e, s_w = best
    D = load_D(topo, K, s_e, s_w)
    e, w = _selection(params, D, s_e, s_w, T)
    return JNCSSResult(s_e=s_e, s_w=s_w, T_tol=float(T), D=D, e=e, w=w)


def brute_force(
    params: ClusterParams, K: int, max_nodes: int = 12
) -> JNCSSResult:
    """Exhaustive search over ALL (s_e, s_w, e, w) — P1 ground truth.

    Exponential; only for small topologies in tests (validates Thm 2).
    """
    topo = params.topo
    if topo.total_workers > max_nodes:
        raise ValueError("brute force limited to tiny topologies")
    A = params.expected_edge_upload()
    best: Optional[Tuple[float, int, int, Tuple, Tuple]] = None
    for s_e in range(topo.n):
        for s_w in range(topo.m_min):
            D = load_D(topo, K, s_e, s_w)
            B = params.expected_worker_total(D)
            f_e = topo.n - s_e
            for edges in itertools.combinations(range(topo.n), f_e):
                # for each chosen edge, all worker subsets of size m_i−s_w
                per_edge_opts = []
                for i in edges:
                    off = sum(topo.m[:i])
                    mi = topo.m[i]
                    opts = []
                    for ws in itertools.combinations(range(mi), mi - s_w):
                        t = A[i] + max(B[off + j] for j in ws)
                        opts.append((t, ws))
                    per_edge_opts.append(min(opts, key=lambda x: x[0]))
                T = max(t for t, _ in per_edge_opts)
                if best is None or T < best[0]:
                    e_vec = tuple(
                        1 if i in edges else 0 for i in range(topo.n)
                    )
                    w_vec: List[Tuple[int, ...]] = []
                    k = 0
                    for i in range(topo.n):
                        if i in edges:
                            ws = per_edge_opts[k][1]
                            k += 1
                            w_vec.append(
                                tuple(
                                    1 if j in ws else 0
                                    for j in range(topo.m[i])
                                )
                            )
                        else:
                            w_vec.append((0,) * topo.m[i])
                    best = (T, s_e, s_w, e_vec, tuple(w_vec))
    T, s_e, s_w, e_vec, w_vec = best
    return JNCSSResult(
        s_e=s_e,
        s_w=s_w,
        T_tol=float(T),
        D=load_D(topo, K, s_e, s_w),
        e=e_vec,
        w=w_vec,
    )


# ----------------------------------------------------------------------
# Theorem 3: a-priori gap bound between T̂ and the stochastic runtime
# ----------------------------------------------------------------------
def order_stat_factor(n: int, r: int) -> float:
    """f(n,r) = sqrt((r−1)/(n(n−r+1))) + sqrt((n−r)/(nr)) (Lemma 1)."""
    if not 1 <= r <= n:
        raise ValueError(f"r={r} outside [1, {n}]")
    return float(
        np.sqrt((r - 1) / (n * (n - r + 1))) + np.sqrt((n - r) / (n * r))
    )


def theorem3_gap_bound(
    params: ClusterParams,
    result: JNCSSResult,
    n_samples: int = 4000,
    seed: int = 0,
) -> float:
    """E|T_tol − T̂| ≤ f(n, n−ŝ_e)·Δ_e + max_i f(m_i, m_i−ŝ_w)·Δ_w^i.

    Δ terms (eq 49) need means/variances of the per-edge totals T^i_tol
    (which include an inner order statistic) — we estimate them by Monte
    Carlo over the runtime model, which is exact in distribution.
    """
    topo = params.topo
    rng = np.random.default_rng(seed)
    s_e, s_w, D = result.s_e, result.s_w, result.D
    W, n = topo.total_workers, topo.n
    worker_samples = np.empty((n_samples, W))
    edge_totals = np.empty((n_samples, n))
    for t in range(n_samples):
        wt, eu, _ = params.sample_iteration(rng, D)
        worker_samples[t] = wt
        off = 0
        for i in range(n):
            mi = topo.m[i]
            edge_totals[t, i] = eu[i] + kth_min(
                wt[off : off + mi], mi - s_w
            )
            off += mi

    def delta(samples: np.ndarray) -> float:
        # eq (49): sqrt( Σ_i [ V[X_i] + (E[X_i] − mean)² ] − k·V[mean] )
        k = samples.shape[1]
        var_i = samples.var(axis=0)
        mean_i = samples.mean(axis=0)
        xbar = samples.mean(axis=1)
        inner = np.sum(var_i + (mean_i - mean_i.mean()) ** 2) - k * xbar.var()
        return float(np.sqrt(max(inner, 0.0)))

    bound = order_stat_factor(n, n - s_e) * delta(edge_totals)
    worst_w = 0.0
    off = 0
    for i in range(n):
        mi = topo.m[i]
        dw = delta(worker_samples[:, off : off + mi])
        worst_w = max(worst_w, order_stat_factor(mi, mi - s_w) * dw)
        off += mi
    return bound + worst_w


# ----------------------------------------------------------------------
# §IV-B homogeneous closed forms
# ----------------------------------------------------------------------
def case1_expected_runtime(
    s_e: int, s_w: int, c: float, K: int, n: int, m: int,
    gamma: float, tau1: float, tau2: float,
) -> float:
    """eq (35): computation-dominated homogeneous expected runtime."""
    k = (n - s_e) * (m - s_w)
    tail = np.log(k) / gamma if k > 1 else 0.0
    return c * K * (s_e + 1) * (s_w + 1) / (n * m) + 2 * tau1 + 2 * tau2 + tail


def homogeneous_case1(
    c: float, K: int, n: int, m: int, gamma: float, tau1: float, tau2: float
) -> Tuple[int, int, float]:
    """§IV-B Case 1: optimum lies at the four corners of the domain."""
    corners = [(0, 0), (n - 1, 0), (0, m - 1), (n - 1, m - 1)]
    vals = [
        (case1_expected_runtime(se, sw, c, K, n, m, gamma, tau1, tau2), se, sw)
        for se, sw in corners
    ]
    v, se, sw = min(vals)
    return se, sw, float(v)


def case2_expected_runtime(
    s_e: int, c: float, K: int, n: int, m: int,
    tau1: float, tau2: float, p2: float,
) -> float:
    """eq (38): communication-dominated homogeneous runtime (s_w = 0)."""
    k = n - s_e
    tail = -2.0 * tau2 / np.log(p2) * np.log(k) if k > 1 else 0.0
    return c * K * (s_e + 1) / (n * m) + 2 * tau1 + tau2 + tail


def homogeneous_case2(
    c: float, K: int, n: int, m: int, tau1: float, tau2: float, p2: float
) -> Tuple[int, int, float]:
    """§IV-B Case 2: optimum at s_e ∈ {0, n−1}, s_w = 0."""
    vals = [
        (case2_expected_runtime(se, c, K, n, m, tau1, tau2, p2), se)
        for se in (0, n - 1)
    ]
    v, se = min(vals)
    return se, 0, float(v)
