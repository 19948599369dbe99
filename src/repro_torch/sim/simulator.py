"""Paper-evaluation simulator (§V): full training runs of every scheme
on the paper's heterogeneous cluster, with sampled per-iteration times.

The port of ``repro.sim.simulator``.  Two modes:
  * ``simulate_times``    — iteration times only (Fig. 8, comm loads;
    numpy, as the reference),
  * ``simulate_training`` — real model training (logistic regression /
    CNN on the synthetic MNIST/CIFAR-like data) where each iteration's
    gradient is the scheme's actual aggregate (exact for coded schemes,
    partial for Greedy) and wall-clock advances by the sampled runtime
    (Figs. 5/6, Table I).

In ``simulate_training`` the data, the weights, the (K, dim) per-part
gradient matrix, the update and the evaluation live on ``device``; each
iteration's aggregate is ``scheme.gradient`` of that matrix, one
coded-combine launch on the card.  Only the aggregate's norm and the
accuracies come to the host.  The sampled times and each part's
minibatch come from the reference's numpy generator in the reference's
order, so ``iter_times_ms`` and the minibatches equal the reference's.

A run computes in float32 with deterministic algorithms, as the
reference does: while its iterations execute, TF32 is off for matmuls
and convolutions and cuDNN picks deterministic algorithms without
benchmarking (:func:`repeatable`), so a run on the card is a function of
its seed; the caller's flags are restored afterwards.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.core.runtime_model import ClusterParams
from repro_torch.core.schemes import Scheme, make_scheme
from repro_torch.data.pipeline import cifar_like, mnist_like, split_K_parts
from repro_torch.models import classic


@dataclasses.dataclass
class TrainingTrace:
    scheme: str
    iter_times_ms: np.ndarray  # (T,)
    losses: np.ndarray  # (T,)
    accuracies: np.ndarray  # (n_evals,)
    eval_times_h: np.ndarray  # cumulative hours at each eval
    eval_iters: np.ndarray

    @property
    def total_time_h(self) -> float:
        return float(self.iter_times_ms.sum() / 3.6e6)

    def time_to_accuracy(self, target: float) -> Optional[float]:
        hits = np.flatnonzero(self.accuracies >= target)
        return float(self.eval_times_h[hits[0]]) if len(hits) else None


def simulate_times(
    scheme: Scheme,
    params: ClusterParams,
    iters: int,
    seed: int = 0,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # grouped schemes carry per-worker loads — compute times then differ
    # per edge; uniform schemes fall back to the scalar D
    D = getattr(scheme, "load_array", scheme.load)
    out = np.empty(iters)
    for t in range(iters):
        sample = params.sample_iteration(rng, D)
        out[t] = scheme.iteration(sample).time
    return out


@contextlib.contextmanager
def repeatable():
    """Float32 with deterministic algorithms, for the duration: TF32 off
    for matmuls and convolutions, cuDNN deterministic and not
    benchmarking.  The four flags are restored to what they were on
    exit, also when the body raises.  Used as a decorator on the
    methods of :class:`TrainingRun` that compute."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


def _make_model(dataset: str, seed: int, device):
    if dataset == "mnist":
        return classic.init_logreg(seed, device=device), classic.apply_logreg
    return classic.init_cnn(seed, device=device), classic.apply_cnn


class TrainingRun:
    """One :func:`simulate_training` run, an iteration at a time.

    The constructor makes the scheme, the data (on ``device``) and the
    model; :meth:`step` runs the next iteration, and the evaluation when
    one is due; :meth:`trace` is the result so far.  ``init_params``
    (a tree like ``models.classic.init_*``'s) replaces the port's own
    seeded initial weights; it is copied, not updated in place.
    """

    def __init__(
        self,
        scheme_name: str,
        params: ClusterParams,
        dataset: str = "mnist",
        non_iid_level: int = 1,
        K: int = 40,
        iters: int = 500,
        lr: float = 0.05,
        batch_per_part: int = 64,
        eval_every: int = 20,
        n_data: int = 8_000,
        n_eval: int = 1_000,
        seed: int = 0,
        s_e: int = 1,
        s_w: int = 1,
        device="cuda",
        init_params=None,
    ):
        dev = self.device = resolve_device(device)
        self.cluster, self.iters, self.lr = params, iters, lr
        self.eval_every = eval_every
        self.scheme_name = scheme_name
        self.scheme = make_scheme(
            scheme_name, params.topo, K, s_e=s_e, s_w=s_w, params=params,
            seed=seed,
        )
        x, y = (mnist_like if dataset == "mnist" else cifar_like)(
            n_data + n_eval, seed=seed
        )
        self.x_eval = torch.as_tensor(x[n_data:], device=dev)
        self.y_eval = torch.as_tensor(y[n_data:], device=dev)
        parts = split_K_parts(
            x[:n_data], y[:n_data], K, non_iid_level, seed=seed
        )
        self.n_parts = len(parts)
        self.px = torch.as_tensor(np.stack([p[0] for p in parts]),
                                  device=dev)  # (K, n_k, ...)
        self.py = torch.as_tensor(np.stack([p[1] for p in parts]),
                                  device=dev)
        self.n_sel = min(batch_per_part, self.px.shape[1])
        self.model_params, self.apply = _make_model(dataset, seed, dev)
        if init_params is not None:
            self.model_params = _tree.map(
                lambda t: torch.as_tensor(t, dtype=torch.float32,
                                          device=dev).clone(), init_params)
        self._leaves = _tree.leaves(self.model_params)
        dim = sum(p.numel() for p in self._leaves)
        # rows 16 bytes apart, so that the combine kernel's vector loads
        # apply: the stride is rounded up to 4 floats, the view is (K, dim)
        stride = -(-dim // 4) * 4
        self.g_parts = torch.empty(K, stride, device=dev)[:, :dim]

        self.rng = np.random.default_rng(seed + 1)
        self.D = getattr(self.scheme, "load_array", self.scheme.load)
        self.t = 0
        self.cum_ms = 0.0
        self.times = np.empty(iters)
        self.losses = np.empty(iters)
        self.accs: List[float] = []
        self.acc_times: List[float] = []
        self.acc_iters: List[int] = []

    @repeatable()
    def part_gradients(self, sel: torch.Tensor) -> torch.Tensor:
        """The (K, dim) per-part gradients at the current weights, part k
        on its rows ``sel`` (each part's own mean CE loss), written into
        :attr:`g_parts` in the reference's flat leaf order."""
        grads = classic.part_grads(self.apply, self.model_params,
                                   self.px[:, sel], self.py[:, sel])
        K, off = self.g_parts.shape[0], 0
        for g in _tree.leaves(grads):
            n = g[0].numel()
            self.g_parts[:, off:off + n].copy_(g.reshape(K, n))
            off += n
        return self.g_parts

    @repeatable()
    def accuracy(self) -> float:
        with torch.no_grad():
            return float(classic.accuracy(
                self.apply(self.model_params, self.x_eval), self.y_eval))

    @repeatable()
    def step(self) -> None:
        """Iteration ``t``: sample its time and minibatch (numpy, the
        reference's order), decode the aggregate, update, evaluate if
        due."""
        t = self.t
        if t >= self.iters:
            raise RuntimeError(f"the run has {self.iters} iterations")
        sample = self.cluster.sample_iteration(self.rng, self.D)
        outcome = self.scheme.iteration(sample)
        self.times[t] = outcome.time
        self.cum_ms += outcome.time
        sel = self.rng.integers(0, self.px.shape[1], size=self.n_sel)
        g_parts = self.part_gradients(torch.as_tensor(sel,
                                                      device=self.device))
        agg = self.scheme.gradient(g_parts, outcome) / max(self.n_parts, 1)
        off = 0
        for leaf in self._leaves:
            n = leaf.numel()
            leaf.sub_(self.lr * agg[off:off + n].view(leaf.shape))
            off += n
        self.losses[t] = float(torch.linalg.vector_norm(agg))
        if t % self.eval_every == 0 or t == self.iters - 1:
            self.accs.append(self.accuracy())
            self.acc_times.append(self.cum_ms / 3.6e6)
            self.acc_iters.append(t)
        self.t += 1

    def trace(self) -> TrainingTrace:
        return TrainingTrace(
            scheme=self.scheme_name,
            iter_times_ms=self.times[:self.t].copy(),
            losses=self.losses[:self.t].copy(),
            accuracies=np.asarray(self.accs),
            eval_times_h=np.asarray(self.acc_times),
            eval_iters=np.asarray(self.acc_iters),
        )


def simulate_training(
    scheme_name: str,
    params: ClusterParams,
    dataset: str = "mnist",
    non_iid_level: int = 1,
    K: int = 40,
    iters: int = 500,
    lr: float = 0.05,
    batch_per_part: int = 64,
    eval_every: int = 20,
    n_data: int = 8_000,
    n_eval: int = 1_000,
    seed: int = 0,
    s_e: int = 1,
    s_w: int = 1,
    device="cuda",
    init_params=None,
) -> TrainingTrace:
    """One full training run of one scheme (Figs. 5/6 & Table I), on
    ``device`` (the card unless the caller asks for the CPU)."""
    run = TrainingRun(
        scheme_name, params, dataset=dataset, non_iid_level=non_iid_level,
        K=K, iters=iters, lr=lr, batch_per_part=batch_per_part,
        eval_every=eval_every, n_data=n_data, n_eval=n_eval, seed=seed,
        s_e=s_e, s_w=s_w, device=device, init_params=init_params,
    )
    for _ in range(iters):
        run.step()
    return run.trace()
