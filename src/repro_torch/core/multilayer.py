"""Corollary 2 — L-layer hierarchical gradient coding.

The paper proves the L-layer bound D/K ≥ Π_l (s_l+1)/W and leaves the
construction implicit; this module provides it by recursing the
two-layer construction: each level ℓ applies a span-condition code over
its children's part-sets, exactly as B/D̄ do for L = 2.

A 3-level deployment maps naturally to (pod, host, chip) — the paper's
"future work" direction, built here as a beyond-paper feature.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.encoding import (
    LinearCode,
    build_random_code,
    build_replication_code,
    cyclic_supports,
)


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """A node in the hierarchy: either an internal node or a worker leaf."""

    children: Tuple["TreeNode", ...] = ()

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def num_leaves(self) -> int:
        if self.is_leaf:
            return 1
        return sum(c.num_leaves() for c in self.children)

    @staticmethod
    def uniform(branching: Sequence[int]) -> "TreeNode":
        """Build a uniform tree, e.g. (2, 4, 8): 2 pods × 4 hosts × 8 chips."""
        if not branching:
            return TreeNode()
        return TreeNode(
            children=tuple(
                TreeNode.uniform(branching[1:]) for _ in range(branching[0])
            )
        )


@dataclasses.dataclass(frozen=True)
class MultiLayerCode:
    """Recursive span-condition code over an L-level tree."""

    tree: TreeNode
    s: Tuple[int, ...]  # per-level straggler tolerance (root-first)
    K: int
    # per internal node (in DFS preorder): the code over its children
    codes: Tuple[LinearCode, ...]
    # leaf → effective coefficient vector over the K parts
    leaf_coeffs: np.ndarray  # (n_leaves, K)
    leaf_parts: Tuple[Tuple[int, ...], ...]

    @property
    def load(self) -> int:
        return len(self.leaf_parts[0])

    @staticmethod
    def build(
        tree: TreeNode, s: Sequence[int], K: int, seed: int = 0
    ) -> "MultiLayerCode":
        codes: List[LinearCode] = []
        leaf_coeffs: List[np.ndarray] = []
        leaf_parts: List[Tuple[int, ...]] = []

        def recurse(node: TreeNode, level: int, parts: Tuple[int, ...],
                    coeff: np.ndarray, rng_seed: int):
            if node.is_leaf:
                leaf_coeffs.append(coeff)
                leaf_parts.append(parts)
                return
            n = len(node.children)
            s_l = s[level]
            if not 0 <= s_l < n:
                raise ValueError(f"s[{level}]={s_l} outside [0:{n})")
            cols = len(parts)
            per = cols * (s_l + 1)
            if per % n:
                raise ValueError(
                    f"level {level}: {cols} parts × (s+1) not divisible "
                    f"by {n} children"
                )
            width = per // n
            sup = cyclic_supports(cols, [width] * n)
            if s_l == 0:
                code = build_replication_code(sup, cols)
            else:
                code = build_random_code(sup, cols, s_l, seed=rng_seed)
            codes.append(code)
            for ci, child in enumerate(node.children):
                child_local = sup[ci]
                child_parts = tuple(parts[j] for j in child_local)
                # effective coefficient: path-product in GLOBAL indices
                child_full = np.zeros(K)
                for j_local in child_local:
                    child_full[parts[j_local]] += code.matrix[ci, j_local]
                child_coeff = coeff * child_full
                recurse(child, level + 1, child_parts,
                        child_coeff, rng_seed * 131 + ci + 1)

        root_coeff = np.ones(K)
        recurse(tree, 0, tuple(range(K)), root_coeff, seed + 1)
        # leaf coeffs are over the global K indices already
        return MultiLayerCode(
            tree=tree,
            s=tuple(s),
            K=K,
            codes=tuple(codes),
            leaf_coeffs=np.stack(leaf_coeffs),
            leaf_parts=tuple(
                tuple(k for k in range(K) if lc[k] != 0.0)
                for lc in leaf_coeffs
            ),
        )

    # ------------------------------------------------------------------
    def decode(
        self,
        g_parts: np.ndarray,  # (K, dim)
        dead_per_level: Optional[Dict[int, set]] = None,
        _node: Optional[TreeNode] = None,
        _level: int = 0,
        _code_idx: Optional[List[int]] = None,
        _parts: Optional[Tuple[int, ...]] = None,
        _leaf_counter: Optional[List[int]] = None,
    ) -> np.ndarray:
        """Recursive decode with per-level straggler sets.

        ``dead_per_level[ℓ]`` holds (preorder child indices at level ℓ)
        that straggled; at most s[ℓ] per parent are tolerated.
        """
        dead_per_level = dead_per_level or {}
        if _node is None:
            _node, _code_idx, _parts = self.tree, [0], tuple(range(self.K))
            _leaf_counter = [0]
        node, parts = _node, _parts
        if node.is_leaf:
            i = _leaf_counter[0]
            _leaf_counter[0] += 1
            return self.leaf_coeffs[i] @ g_parts
        code = self.codes[_code_idx[0]]
        _code_idx[0] += 1
        results = {}
        dead = dead_per_level.get(_level, set())
        for ci, child in enumerate(node.children):
            sub = self.decode(
                g_parts, dead_per_level, child, _level + 1, _code_idx,
                tuple(parts[j] for j in code.supports[ci]), _leaf_counter,
            )
            results[ci] = sub
        alive = [ci for ci in results if ci not in dead]
        f = code.f
        fast = alive[:f] if len(alive) >= f else alive
        w = code.full_decode_weights(fast)
        out = None
        for ci in fast:
            term = w[ci] * results[ci]
            out = term if out is None else out + term
        return out


def min_load_fraction(branching: Sequence[int],
                      s: Sequence[int]) -> Fraction:
    """Corollary 2 bound for a uniform tree."""
    W = 1
    for b in branching:
        W *= b
    num = 1
    for s_l in s:
        num *= s_l + 1
    return Fraction(num, W)
