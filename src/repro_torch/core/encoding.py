"""Encoding-matrix construction — paper §III-A (Conditions 1 & 2).

Two constructions are provided for a support-constrained code whose every
``f``-row subset must span the all-ones vector:

* ``random``  — paper-faithful generic construction: i.i.d. Gaussian
  coefficients on the prescribed (cyclic) supports.  Condition 1/2 holds
  with probability 1 (the supports cover every column ≥ s+1 times, so the
  span property is generic); we *verify* it explicitly after construction
  and re-seed on the (measure-zero) failure event.  Decoding uses
  least-squares in float64 — residuals are checked to be numerically zero.

* ``frc``     — fractional-repetition code (Tandon et al. [14]): when
  (s+1) | rows and the supports can be organized as s+1 groups each
  partitioning the columns, all coefficients are 1 and decoding weights
  are exactly {0, 1}.  Perfectly conditioned — the right choice for bf16
  gradient payloads at scale.  Used when divisibility permits and the
  caller opts in (beyond-paper robustness feature; the *paper's* cyclic
  supports remain the default).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Residual threshold for "exact" float64 decode.
_DECODE_RTOL = 1e-8
# Max number of subsets to exhaustively verify; sample beyond this.
_MAX_EXHAUSTIVE = 512


class CodeConstructionError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class LinearCode:
    """A support-constrained code: ``matrix`` rows combine column-items.

    Guarantee (verified at construction): for any ``num_rows - s`` rows,
    the all-ones row vector lies in their span.
    """

    matrix: np.ndarray  # (rows, cols) float64
    supports: Tuple[Tuple[int, ...], ...]  # per-row non-zero columns
    s: int  # tolerated straggling rows

    @property
    def rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def cols(self) -> int:
        return self.matrix.shape[1]

    @property
    def f(self) -> int:
        """Number of rows needed to decode."""
        return self.rows - self.s

    def decode_vector(self, fast_rows: Sequence[int]) -> np.ndarray:
        """Solve a · M[fast] = 1 (least squares, residual-checked)."""
        fast = sorted(set(fast_rows))
        if len(fast) < self.f:
            raise ValueError(
                f"need ≥ {self.f} rows to decode, got {len(fast)}"
            )
        sub = self.matrix[fast, :]  # (f', cols)
        ones = np.ones(self.cols, dtype=np.float64)
        a, *_ = np.linalg.lstsq(sub.T, ones, rcond=None)
        resid = float(np.max(np.abs(a @ sub - ones)))
        if resid > _DECODE_RTOL:
            raise CodeConstructionError(
                f"decode failed for rows {fast}: residual {resid:.2e}"
            )
        return a

    def full_decode_weights(self, fast_rows: Sequence[int]) -> np.ndarray:
        """Length-``rows`` decode vector, zero on straggling rows."""
        a = self.decode_vector(fast_rows)
        w = np.zeros(self.rows, dtype=np.float64)
        for weight, r in zip(a, sorted(set(fast_rows))):
            w[r] = weight
        return w


def cyclic_supports(
    cols: int, sizes: Sequence[int], offsets: Optional[Sequence[int]] = None
) -> Tuple[Tuple[int, ...], ...]:
    """Cyclic windows over ``cols`` columns (paper eqs (16)/(19))."""
    out: List[Tuple[int, ...]] = []
    off = 0
    for r, size in enumerate(sizes):
        start = offsets[r] if offsets is not None else off
        out.append(tuple((start + t) % cols for t in range(size)))
        off += size
    return tuple(out)


def _segments_by_cover(
    supports: Sequence[Sequence[int]], cols: int
) -> Tuple[List[List[int]], List[Tuple[int, ...]]]:
    """Group columns by the exact set of rows covering them.

    The cyclic assignment (eqs 16/19) produces at most ``len(supports)``
    distinct cover-sets, collapsing the K-column construction problem to
    a small segment-level one (this is what makes the paper's Example 1
    coefficients piecewise-constant).
    Returns (segment -> column list, segment -> covering row tuple).
    """
    cover_of_col: List[Tuple[int, ...]] = []
    col_rows: List[List[int]] = [[] for _ in range(cols)]
    for r, sup in enumerate(supports):
        for c in set(sup):
            col_rows[c].append(r)
    seg_index: dict = {}
    seg_cols: List[List[int]] = []
    seg_cover: List[Tuple[int, ...]] = []
    for c in range(cols):
        key = tuple(col_rows[c])
        if not key:
            raise CodeConstructionError(f"column {c} covered by no row")
        if key not in seg_index:
            seg_index[key] = len(seg_cols)
            seg_cols.append([])
            seg_cover.append(key)
        seg_cols[seg_index[key]].append(c)
    return seg_cols, seg_cover


def build_random_code(
    supports: Sequence[Sequence[int]],
    cols: int,
    s: int,
    seed: int = 0,
    max_retries: int = 16,
) -> LinearCode:
    """Span-condition code on the given supports (null-space construction).

    Segment reduction first: columns with identical cover-sets share one
    coefficient per row.  At segment level (n_seg segments, f = rows−s
    needed rows) we pick a subspace ``V = null(H)`` with ``H·1 = 0`` and
    draw each row's segment-coefficients randomly *inside* V restricted
    to its segment support — so every f-row subset generically spans V ∋ 1.
    When f ≥ n_seg (no H needed) plain random coefficients suffice.
    The span condition is verified explicitly; re-seeded on failure.
    """
    rows = len(supports)
    if not 0 <= s < rows:
        raise ValueError(f"s={s} outside [0:{rows})")
    f = rows - s
    seg_cols, seg_cover = _segments_by_cover(supports, cols)
    n_seg = len(seg_cols)
    # segment-level supports
    row_segs: List[List[int]] = [[] for _ in range(rows)]
    for t, cov in enumerate(seg_cover):
        for r in cov:
            row_segs[r].append(t)
    q = n_seg - f  # codim of the common subspace V within segment space

    rng = np.random.default_rng(seed)
    for _attempt in range(max_retries):
        seg_mat = np.zeros((rows, n_seg), dtype=np.float64)
        if q <= 0 or any(len(rs) <= q for rs in row_segs):
            # f ≥ n_seg (or a row too narrow for the H-method): plain
            # random coefficients; verification gates correctness.
            for r in range(rows):
                seg_mat[r, row_segs[r]] = rng.normal(size=len(row_segs[r]))
        else:
            # H q×n_seg with H·1 = 0 ⇒ 1 ∈ V = null(H), dim V = f.
            H = rng.normal(size=(q, n_seg))
            H[:, -1] -= H.sum(axis=1)  # rows sum to 0
            for r in range(rows):
                sub = H[:, row_segs[r]]  # q × |C_r|
                # random vector in null(sub): |C_r| > q ⇒ dim ≥ 1
                _u, sv, vt = np.linalg.svd(sub, full_matrices=True)
                null_dim = vt.shape[0] - np.sum(sv > 1e-12)
                if null_dim < 1:
                    break
                basis = vt[vt.shape[0] - null_dim:, :].T  # |C_r| × null_dim
                vec = basis @ rng.normal(size=null_dim)
                seg_mat[r, row_segs[r]] = vec
            else:
                pass
        # normalize rows for conditioning (scale-invariant condition)
        norms = np.linalg.norm(seg_mat, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        seg_mat = seg_mat / norms * np.sqrt(n_seg)
        # expand segments to columns
        mat = np.zeros((rows, cols), dtype=np.float64)
        for t, cs in enumerate(seg_cols):
            mat[:, cs] = seg_mat[:, [t]]
        code = LinearCode(
            matrix=mat,
            supports=tuple(tuple(sup) for sup in supports),
            s=s,
        )
        if verify_span_condition(code):
            return code
    raise CodeConstructionError(
        f"failed to build a valid code after {max_retries} seeds "
        f"(rows={rows}, cols={cols}, s={s}, n_seg={n_seg})"
    )


def build_replication_code(
    supports: Sequence[Sequence[int]], cols: int
) -> LinearCode:
    """s=0 code: coefficients all 1; decode = plain sum.

    Valid when the supports *partition* the columns (each column covered
    exactly once) — the Uncoded / s=0 case.
    """
    rows = len(supports)
    cover = np.zeros(cols, dtype=np.int64)
    mat = np.zeros((rows, cols), dtype=np.float64)
    for r, sup in enumerate(supports):
        mat[r, list(sup)] = 1.0
        cover[list(sup)] += 1
    if not np.all(cover == 1):
        raise CodeConstructionError("supports do not partition the columns")
    return LinearCode(matrix=mat, supports=tuple(map(tuple, supports)), s=0)


def build_frc_code(rows: int, cols: int, s: int) -> LinearCode:
    """Fractional-repetition code (all-ones coefficients, {0,1} decode).

    Requires (s+1) | rows and (rows/(s+1)) | cols.  Rows are organized
    into s+1 groups; each group partitions the columns equally.
    """
    if (s + 1) <= 0 or rows % (s + 1) != 0:
        raise CodeConstructionError(f"(s+1)={s+1} must divide rows={rows}")
    per_group = rows // (s + 1)
    if cols % per_group != 0:
        raise CodeConstructionError(
            f"group size {per_group} must divide cols={cols}"
        )
    width = cols // per_group
    mat = np.zeros((rows, cols), dtype=np.float64)
    supports: List[Tuple[int, ...]] = []
    r = 0
    for _g in range(s + 1):
        for k in range(per_group):
            sup = tuple(range(k * width, (k + 1) * width))
            mat[r, list(sup)] = 1.0
            supports.append(sup)
            r += 1
    return LinearCode(matrix=mat, supports=tuple(supports), s=s)


def frc_decode_weights(code: LinearCode, fast_rows: Sequence[int]) -> np.ndarray:
    """Combinatorial {0,1} decode for FRC codes: pick one complete group."""
    fast = set(fast_rows)
    per_group = code.rows // (code.s + 1)
    for g in range(code.s + 1):
        members = list(range(g * per_group, (g + 1) * per_group))
        if all(m in fast for m in members):
            w = np.zeros(code.rows, dtype=np.float64)
            w[members] = 1.0
            return w
    raise CodeConstructionError(
        f"no complete group among fast rows {sorted(fast)}"
    )


def verify_span_condition(
    code: LinearCode, rng: Optional[np.random.Generator] = None
) -> bool:
    """Check Condition 1/2: every f-subset of rows spans the ones vector.

    Exhaustive when C(rows, f) ≤ 512, else randomized subset sampling
    (512 samples) — failures are measure-zero for the random construction,
    and downstream ``decode_vector`` residual checks give a second gate.
    """
    rows, f = code.rows, code.f
    all_subsets = itertools.combinations(range(rows), f)
    import math

    n_total = math.comb(rows, f)
    if n_total <= _MAX_EXHAUSTIVE:
        subsets = list(all_subsets)
    else:
        rng = rng or np.random.default_rng(1234)
        subsets = [
            tuple(sorted(rng.choice(rows, size=f, replace=False)))
            for _ in range(_MAX_EXHAUSTIVE)
        ]
    ones = np.ones(code.cols, dtype=np.float64)
    for sub in subsets:
        m = code.matrix[list(sub), :]
        a, *_ = np.linalg.lstsq(m.T, ones, rcond=None)
        if np.max(np.abs(a @ m - ones)) > _DECODE_RTOL:
            return False
    return True
