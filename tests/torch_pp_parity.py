"""The reference side of the port's pipeline-parallel parity tests
(``tests/test_torch_pp*.py``): the port's dist train step with a "stage"
axis of 2 ranks against the reference's single-device step, for all ten
configs and the reference's compositions.

The construction of the reference's ``tests/test_pp_parity.py``: the
global batch is one quarter-batch tiled over the (pod, data) groups with
λ = 1 / groups, so the coded decode Σ λ_ij G_ij is the plain gradient of
that quarter, which the reference's ``make_train_step`` computes
directly (in this process, on the CPU).  Each group's rows split into
microbatches that stream through the stages.  One step from the
reference's initial weights must give the same loss and the same updated
params: 2e-5 on the loss and 3e-5 on the params, the reference test's
tolerances; over the int8 hop each leaf's params are held within one
int8 step of its largest update (at most the reference test's 5e-3).
Every case steps at the full learning rate (``warmup_steps=0``): the
reference test's ``warmup_steps=1`` gives lr 0 at step 0, so its params
check compares the initial weights with themselves.

The configs whose smoke depth has too few layer groups for 2 stages are
deepened as the reference test deepens them (``DEEPEN``); the MoE configs
run one microbatch (their capacity and mean-based aux depend on the
token count).  Beyond the reference's cases, ``llama3-8b@pp2-clip``
clips (the global norm must sum the stage-split leaves over "stage") and
``gemma3-27b-adafactor@pp2`` steps under adafactor (its factored
statistics of a ``groups`` norm scale reduce over the stage axis), and
``llama3-8b@pp1m2`` asks one stage (one rank) for two microbatches,
which the dist step ignores, as the reference's does.
The worlds: the archs, ``@pp2m4`` and the two extra cases at (stage 2,
pod 1, data 1: every (pod, data) group in turn on each of 2 ranks); the
TP compositions at (stage 2, model 2), 4 ranks; ``@pp2int8`` at (stage
2, pod 2, data 2), 8 ranks, so that the hop's all-gather crosses pod
ranks.  One world per layout serves its cases.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import torch_tp_ranks as ranks
from repro.checkpoint.store import _flatten
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import transformer as jtf
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.dist.launch import run_ranks

S = 16
SGD = dict(optimizer="sgd", lr=0.05, total_steps=10, warmup_steps=0,
           grad_clip=0.0)
# the reference test's deepened configs (pp splits the layer groups)
DEEPEN = {"granite-8b": 4, "gemma3-27b": 14, "recurrentgemma-2b": 8}
MOE_M1 = {"granite-moe-3b-a800m", "llama4-maverick-400b-a17b"}
# case → dict(arch, tcfg, seed, layers, bq, microbatches, pods, data, tp)
CASES = {}
for _i, _arch in enumerate(ARCH_IDS):
    CASES[_arch] = dict(arch=_arch, tcfg=SGD, seed=1000 + _i,
                        layers=DEEPEN.get(_arch),
                        microbatches=1 if _arch in MOE_M1 else 2)
_LLAMA = dict(arch="llama3-8b", microbatches=2)
CASES.update({
    "llama3-8b@pp2tp2": dict(_LLAMA, tcfg=SGD, seed=2001, pods=2, data=1,
                             tp=2),
    "llama3-8b@pp2tp2sp": dict(_LLAMA, tcfg=dict(
        SGD, seq_shard_activations=True), seed=2002, pods=2, data=1, tp=2),
    "llama3-8b@pp2int8": dict(_LLAMA, tcfg=dict(
        SGD, grad_compression="int8"), seed=2003),
    "llama3-8b@pp2tp2sp-int8": dict(_LLAMA, tcfg=dict(
        SGD, seq_shard_activations=True, grad_compression="int8"),
        seed=2004, pods=2, data=1, tp=2),
    "llama3-8b@pp2m4": dict(arch="llama3-8b", tcfg=SGD, seed=2005, layers=4,
                            microbatches=4, bq=4),
    "llama3-8b@pp2-clip": dict(_LLAMA, tcfg=dict(SGD, grad_clip=0.05),
                               seed=2006),
    "gemma3-27b-adafactor@pp2": dict(arch="gemma3-27b", tcfg=dict(
        SGD, optimizer="adafactor"), seed=2007, layers=14, microbatches=2),
    # one stage: the microbatch count is ignored (the reference's rule)
    "llama3-8b@pp1m2": dict(_LLAMA, tcfg=SGD, seed=2008, pp=1),
})
ARCHS_A = ["llama3-8b", "granite-8b", "starcoder2-3b", "gemma3-27b",
           "qwen2-vl-2b"]
ARCHS_B = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
           "mamba2-370m", "recurrentgemma-2b", "whisper-medium"]
assert sorted(ARCHS_A + ARCHS_B) == sorted(ARCH_IDS)
# layout → (pods, data, tp, world, cases)
WORLDS = {
    "stage2-archs-a": (2, 2, 1, 2, ARCHS_A),
    "stage2-archs-b": (2, 2, 1, 2, ARCHS_B),
    "stage2-extra": (2, 2, 1, 2, ["llama3-8b@pp2m4", "llama3-8b@pp2-clip",
                                  "gemma3-27b-adafactor@pp2"]),
    "stage2-model2": (2, 1, 2, 4, ["llama3-8b@pp2tp2", "llama3-8b@pp2tp2sp",
                                   "llama3-8b@pp2tp2sp-int8"]),
    "stage2-pod2-data2": (2, 2, 1, 8, ["llama3-8b@pp2int8"]),
    "stage1-m2": (2, 2, 1, 1, ["llama3-8b@pp1m2"]),
}


def _ref_cfg(arch, layers):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


@functools.lru_cache(maxsize=None)
def inputs(case):
    """The reference's initial params (flat numpy) and the quarter batch
    (whisper's with its encoder frames, as the reference test's)."""
    c = CASES[case]
    cfg = _ref_cfg(c["arch"], c.get("layers"))
    bq = c.get("bq", 2)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(c["seed"])
    quarter = {
        "tokens": rng.integers(0, cfg.vocab, (bq, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (bq, S)).astype(np.int32),
        "weights": np.ones((bq, S), np.float32),
        "denom": np.float32(bq * S),
    }
    if cfg.is_encdec:
        quarter["enc_frames"] = rng.normal(
            size=(bq, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return flat, quarter


@functools.lru_cache(maxsize=None)
def reference(case):
    """One step of the reference's single-device ``make_train_step`` on
    the quarter → (loss, grad_norm, flat params)."""
    c = CASES[case]
    cfg = _ref_cfg(c["arch"], c.get("layers"))
    _, quarter = inputs(case)
    tcfg = {k: v for k, v in c["tcfg"].items()
            if k != "seq_shard_activations"}
    rtcfg = RefTrainConfig(**tcfg)
    opt = ref_make_optimizer(rtcfg.optimizer)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    step = jax.jit(ref_steps.make_train_step(cfg, rtcfg, optimizer=opt))
    new, _, m = step(params, opt.init(params),
                     {k: jnp.asarray(v) for k, v in quarter.items()},
                     jnp.asarray(0))
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: np.asarray(v) for k, v in _flatten(new).items()})


def port_steps(layouts, timeout=600):
    """(layout, case) → rank 0's step of the port, for ``layouts``."""
    out = {}
    for layout in layouts:
        pods, data, tp, world, names = WORLDS[layout]
        groups = pods * data
        cases = []
        for name in names:
            c = CASES[name]
            flat, quarter = inputs(name)
            full = {k: (v if np.ndim(v) == 0 else
                        np.tile(v, (groups,) + (1,) * (np.ndim(v) - 1)))
                    for k, v in quarter.items()}
            changes = {"n_layers": c["layers"]} if c.get("layers") else {}
            pp = c.get("pp", 2)
            cases.append(dict(
                arch=c["arch"], tcfg=dict(c["tcfg"], pp_stages=pp,
                                          microbatches=c["microbatches"]),
                params=flat, batch=full, pods=pods, data=data, tp=tp, pp=pp,
                changes=changes))
        res = run_ranks(ranks.train_cases, world, args=(cases,),
                        timeout=timeout)[0]
        out.update({(layout, n): r for n, r in zip(names, res)})
    return out


def check(got, case):
    """The port's pipelined step against the reference's single-device
    step, at the reference test's tolerances."""
    loss, grad_norm, params = reference(case)
    init, _ = inputs(case)
    compressed = "int8" in case
    # the loss is decoded before any gradient is quantized
    assert abs(got["loss"] - loss) < 2e-5, (got["loss"], loss)
    if not compressed:
        assert abs(got["grad_norm"] - grad_norm) < 1e-5 * max(grad_norm, 1)
    assert set(got["params"]) == set(params)
    for k, want in params.items():
        atol = 3e-5
        if compressed:
            # one int8 step (block max / 127) of the leaf's largest update
            atol = min(5e-3, float(np.max(np.abs(want - init[k]))) / 127)
        np.testing.assert_allclose(got["params"][k], want, rtol=0,
                                   atol=atol, err_msg=f"{case} {k}")
