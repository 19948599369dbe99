"""The reference side of the port's tensor-parallel parity tests
(``tests/test_torch_tp*.py``): the port's dist train step under TP
against the reference's single-device step, for the five dense configs.

The construction of the reference's ``tests/test_tp_parity.py``: the
global batch is one quarter-batch tiled over the (pod, data) groups with
λ = 1 / groups, so the coded decode Σ λ_ij G_ij is the plain gradient of
that quarter, which the reference's ``make_train_step`` computes
directly (in this process, on the CPU).  One step from the reference's
initial weights must give the same loss and the same updated params:
2e-5 on the loss and 3e-5 on the params, the reference test's
tolerances; over the int8 hop each leaf's params are held within one
int8 step of its largest update (at most the reference test's 5e-3).
The step runs at the full learning rate (no warm-up), so the params
check sees the update: at lr 0 it would compare the initial weights
with themselves.

The port's step runs in the ranks of ``dist.launch.run_ranks`` (gloo,
float32): at (pod 2, data 2, model 2), every group on ranks of its own
(8 ranks, the int8 hop's all-gather over real pod ranks), and at
(1, 1, 2), every group in turn on each of 2 ranks; starcoder2-3b also at
tp 4 (2 KV heads: replicated K/V, each rank slicing the head of its Q
block).  gemma3-27b steps under adafactor (its factored statistics
reduce over the split axis) and one llama3-8b case clips, so the global
gradient norm must match tp 1 (``tests/test_torch_dist_mesh.py`` also
holds the optimizer's reductions on slices directly).  One world per
layout serves every case; the layouts are split over two test files so
that the suite's workers share them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import torch_tp_ranks as ranks
from repro.checkpoint.store import _flatten
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import transformer as jtf
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.dist.launch import run_ranks

BQ, S = 2, 16  # the quarter batch: what one group sees

SGD = dict(optimizer="sgd", lr=0.05, total_steps=10, warmup_steps=0,
           grad_clip=0.0)
# case → (arch, train config, batch seed)
CASES = {
    "llama3-8b": ("llama3-8b", SGD, 1000),
    "granite-8b": ("granite-8b", SGD, 1001),
    "starcoder2-3b": ("starcoder2-3b", SGD, 1002),
    "gemma3-27b-adafactor": ("gemma3-27b", dict(SGD, optimizer="adafactor"),
                             1003),
    "qwen2-vl-2b": ("qwen2-vl-2b", SGD, 1004),
    "llama3-8b-clip": ("llama3-8b", dict(SGD, grad_clip=0.05), 1005),
    "llama3-8b-int8": ("llama3-8b", dict(SGD, grad_compression="int8"),
                       2003),
}
# layout → (pods, data, tp, world, cases)
WORLDS = {
    "pod2-data2-model2": (2, 2, 2, 8, list(CASES)),
    "pod1-data1-model2": (2, 2, 2, 2, ["llama3-8b", "granite-8b",
                                       "starcoder2-3b",
                                       "gemma3-27b-adafactor",
                                       "qwen2-vl-2b", "llama3-8b-int8"]),
    "pod1-data1-model4": (1, 2, 4, 4, ["starcoder2-3b"]),
}


def _ref_cfg(arch):
    return dataclasses.replace(ref_smoke(arch), dtype="float32")


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """The reference's initial params (flat numpy) and the quarter batch."""
    arch, _, seed = CASES[case]
    cfg = _ref_cfg(arch)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(seed)
    quarter = {
        "tokens": rng.integers(0, cfg.vocab, (BQ, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (BQ, S)).astype(np.int32),
        "weights": np.ones((BQ, S), np.float32),
        "denom": np.float32(BQ * S),
    }
    return flat, quarter


@functools.lru_cache(maxsize=None)
def _reference(case):
    """One step of the reference's single-device ``make_train_step`` on
    the quarter → (loss, grad_norm, flat params)."""
    arch, tcfg, _ = CASES[case]
    cfg = _ref_cfg(arch)
    flat, quarter = _inputs(case)
    rtcfg = RefTrainConfig(**tcfg)
    opt = ref_make_optimizer(rtcfg.optimizer)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    step = jax.jit(ref_steps.make_train_step(cfg, rtcfg, optimizer=opt))
    new, _, m = step(params, opt.init(params),
                     {k: jnp.asarray(v) for k, v in quarter.items()},
                     jnp.asarray(0))
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: np.asarray(v) for k, v in _flatten(new).items()})


def port_steps(layouts):
    """(layout, case) → rank 0's step of the port, for ``layouts``."""
    out = {}
    for layout in layouts:
        pods, data, tp, world, names = WORLDS[layout]
        groups = pods * data
        cases = []
        for name in names:
            arch, tcfg, _ = CASES[name]
            flat, quarter = _inputs(name)
            full = {k: (v if np.ndim(v) == 0 else
                        np.tile(v, (groups,) + (1,) * (np.ndim(v) - 1)))
                    for k, v in quarter.items()}
            cases.append(dict(arch=arch, tcfg=tcfg, params=flat, batch=full,
                              pods=pods, data=data, tp=tp))
        res = run_ranks(ranks.train_cases, world, args=(cases,),
                        timeout=600)[0]
        out.update({(layout, n): r for n, r in zip(names, res)})
    return out


def check(got, case):
    """The port's step against the reference's, at the reference test's
    tolerances."""
    loss, grad_norm, params = _reference(case)
    init, _ = _inputs(case)
    compressed = "int8" in case
    # the loss is decoded before any gradient is quantized
    assert abs(got["loss"] - loss) < 2e-5, (got["loss"], loss)
    if not compressed:
        assert abs(got["grad_norm"] - grad_norm) < 1e-5 * max(grad_norm, 1)
    assert set(got["params"]) == set(params)
    for k, want in params.items():
        atol = 3e-5
        if compressed:
            # one int8 step (block max / 127) of the leaf's largest sgd
            # update lr·g: twice the rounding error of each pod's
            # quantized partial, and far below the update itself (the
            # reference test's 5e-3 would pass a zero update)
            atol = min(5e-3, float(np.max(np.abs(want - init[k]))) / 127)
        np.testing.assert_allclose(got["params"][k], want, rtol=0,
                                   atol=atol, err_msg=f"{case} {k}")
