"""Data pipeline: deterministic synthetic datasets, the paper's non-IID
partitioner, K-part assignment-aware loaders, and token streams.

The container is offline, so MNIST/CIFAR are stood in by deterministic
synthetic datasets with identical shapes and a class structure that
makes the paper's non-IID levels meaningful (per-class Gaussian modes —
a linear/CNN model genuinely has to separate classes, and dropping a
part biases the gradient exactly as in the paper).  EXPERIMENTS.md
validates *relative* scheme behaviour against the paper's claims.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.assignment import Assignment
from repro_torch.core.topology import Topology


# ----------------------------------------------------------------------
# synthetic image-classification datasets (MNIST-like / CIFAR-like)
# ----------------------------------------------------------------------
def synthetic_classification(
    n: int,
    shape: Tuple[int, ...],
    n_classes: int = 10,
    seed: int = 0,
    class_sep: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian class-mode dataset: x = μ_class + ε, deterministic."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(shape))
    mus = rng.normal(size=(n_classes, dim)) * class_sep / np.sqrt(dim)
    y = rng.integers(0, n_classes, size=n)
    x = mus[y] + rng.normal(size=(n, dim)) * 0.5
    return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int64)


def mnist_like(n: int = 10_000, seed: int = 0):
    """784-feature 10-class stand-in (paper's MNIST-LR experiment)."""
    return synthetic_classification(n, (784,), 10, seed)


def cifar_like(n: int = 10_000, seed: int = 1):
    """32×32×3 10-class stand-in (paper's CIFAR-CNN experiment)."""
    return synthetic_classification(n, (32, 32, 3), 10, seed)


# ----------------------------------------------------------------------
# the paper's K-part splits and non-IID levels (§V-A)
# ----------------------------------------------------------------------
def split_K_parts(
    x: np.ndarray,
    y: np.ndarray,
    K: int,
    non_iid_level: int = 1,
    n_classes: int = 10,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """K disjoint sub-datasets at the paper's non-IID levels:

      Level 1 — samples drawn from all classes,
      Level 2 — each part sees ≤ 5 classes,
      Level 3 — each part sees ≤ 2 classes.
    """
    rng = np.random.default_rng(seed)
    max_types = {1: n_classes, 2: 5, 3: 2}[non_iid_level]
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    ptr = [0] * n_classes
    per_part = len(y) // K
    parts = []
    for k in range(K):
        classes = rng.choice(n_classes, size=max_types, replace=False)
        idxs: List[int] = []
        # round-robin over the allowed classes until the part is full
        ci = 0
        guard = 0
        while len(idxs) < per_part and guard < 10 * per_part:
            c = classes[ci % len(classes)]
            if ptr[c] < len(by_class[c]):
                idxs.append(by_class[c][ptr[c]])
                ptr[c] += 1
            ci += 1
            guard += 1
        if len(idxs) < per_part:  # refill from any class
            pool = np.concatenate(
                [bc[p:] for bc, p in zip(by_class, ptr) if p < len(bc)]
            )
            idxs.extend(pool[: per_part - len(idxs)].tolist())
        idxs = np.asarray(idxs[:per_part])
        parts.append((x[idxs], y[idxs]))
    return parts


def worker_part_loader(
    parts: Sequence[Tuple[np.ndarray, np.ndarray]],
    assignment: Assignment,
) -> Dict[Tuple[int, int], List[int]]:
    """Worker (i,j) → the global part ids it must process (eq. 19)."""
    out = {}
    for i in range(assignment.topo.n):
        for j in range(assignment.topo.m[i]):
            out[(i, j)] = list(assignment.worker_parts(i, j))
    return out


# ----------------------------------------------------------------------
# token streams for the LM architectures
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM token stream with resumable state.

    The iterator state (step counter) is part of the training
    checkpoint, so restart resumes the exact data order — required for
    the fault-tolerance story.
    """

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step])
        )
        # structured stream: a noisy periodic source so a real LM can
        # actually reduce loss on it
        base = rng.integers(0, self.vocab, size=(self.batch, 1))
        drift = np.arange(self.seq_len)[None, :]
        tokens = (base + drift + rng.integers(0, 3, size=(
            self.batch, self.seq_len))) % self.vocab
        self.step += 1
        targets = np.roll(tokens, -1, axis=1)
        return {
            "tokens": tokens.astype(np.int32),
            "targets": targets.astype(np.int32),
            "weights": np.ones((self.batch, self.seq_len), np.float32),
        }

    def state_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: Dict):
        self.seed, self.step = int(d["seed"]), int(d["step"])


def coded_batch(
    stream_parts: Sequence[Dict[str, np.ndarray]],
    coeffs: Sequence[float],
) -> Dict[str, np.ndarray]:
    """Stack a worker's assigned parts into one batch whose example
    weights carry the HGC coding coefficients (DESIGN.md §3).

    The gradient of the weighted loss on this batch IS the worker's
    encoded message G_ij.
    """
    tokens = np.concatenate([p["tokens"] for p in stream_parts], 0)
    targets = np.concatenate([p["targets"] for p in stream_parts], 0)
    weights = np.concatenate(
        [p["weights"] * c for p, c in zip(stream_parts, coeffs)], 0
    )
    return {"tokens": tokens, "targets": targets, "weights": weights}
