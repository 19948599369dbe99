"""The reference side of the port's tensor-parallel parity tests
(``tests/test_torch_tp*.py``): the port's dist train step under TP, and
under TP with sequence parallelism (``<arch>@sp``), against the
reference's single-device step, for all ten configs.

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
holds the optimizer's reductions on slices directly).  The MoE configs
run expert-parallel (granite-moe-3b-a800m's 8 smoke experts split; at 5
experts, ``granite-moe-E5@tp2-eprep``, they are replicated and the
router must not be gathered), mamba2-370m over a rank's SSD heads,
recurrentgemma-2b with row-parallel RG-LRU gates, whisper-medium with
its encoder and cross block at a rank's heads (its batches carry
``enc_frames``, as the reference test's).  The ``@sp`` cases run the
same step with the activations sequence-sharded between the TP
collective pairs; their reference is the non-SP case's (SP changes no
value).  One world per layout serves every case; the layouts are split
over several test files so that the suite's workers share them.
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
SP = dict(seq_shard_activations=True)
DENSE = ["llama3-8b", "granite-8b", "starcoder2-3b", "gemma3-27b-adafactor",
         "qwen2-vl-2b"]
ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
         "mamba2-370m", "recurrentgemma-2b", "whisper-medium"]
# case → (arch, train config, batch seed[, config changes])
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
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", SGD, 1006),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", SGD, 1007),
    "mamba2-370m": ("mamba2-370m", SGD, 1008),
    "recurrentgemma-2b": ("recurrentgemma-2b", SGD, 1009),
    "whisper-medium": ("whisper-medium", SGD, 1010),
    # replicated experts (E % tp != 0): the router must not be gathered
    "granite-moe-E5@tp2-eprep": ("granite-moe-3b-a800m", SGD, 2002,
                                 dict(n_experts=5)),
    # sequence parallelism composes with the int8 + EF cross-pod hop
    "llama3-8b-int8@sp": ("llama3-8b", dict(SGD, grad_compression="int8",
                                            **SP), 2004),
}
for _name in DENSE + ARCHS:  # every arch again, sequence-parallel
    _arch, _tcfg, _seed = CASES[_name]
    CASES[_name.replace("-adafactor", "") + "@sp"] = (
        _arch, dict(_tcfg, **SP), _seed)
# layout → (pods, data, tp, world, cases): the layouts "pod1-data1-…"
# hold every (pod, data) group in turn on each rank
WORLDS = {
    "pod2-data2-model2": (2, 2, 2, 8, ["llama3-8b", "granite-8b",
                                       "starcoder2-3b",
                                       "gemma3-27b-adafactor",
                                       "qwen2-vl-2b", "llama3-8b-clip",
                                       "llama3-8b-int8",
                                       "llama3-8b-int8@sp"]),
    "pod1-data1-model2": (2, 2, 2, 2, ["llama3-8b", "granite-8b",
                                       "starcoder2-3b",
                                       "gemma3-27b-adafactor",
                                       "qwen2-vl-2b", "llama3-8b-int8",
                                       "llama3-8b-int8@sp"]),
    "pod1-data1-model4": (1, 2, 4, 4, ["starcoder2-3b"]),
    "pod1-data1-model2-sp": (2, 2, 2, 2, ["llama3-8b@sp", "granite-8b@sp",
                                          "starcoder2-3b@sp",
                                          "gemma3-27b@sp",
                                          "qwen2-vl-2b@sp"]),
    "pod1-data1-model2-archs": (2, 2, 2, 2, ARCHS),
    "pod1-data4-model2-eprep": (1, 4, 2, 2, ["granite-moe-E5@tp2-eprep"]),
    "pod1-data1-model2-archs-sp": (2, 2, 2, 2, [a + "@sp" for a in ARCHS]),
}


def _case(case):
    """(arch, train config, seed, config changes) of ``case``."""
    arch, tcfg, seed, *rest = CASES[case]
    return arch, tcfg, seed, (rest[0] if rest else {})


def _ref_cfg(arch, changes=()):
    return dataclasses.replace(ref_smoke(arch), dtype="float32",
                               **dict(changes))


def _inputs(case):
    arch, _, seed, changes = _case(case)
    return _inputs_of(arch, seed, tuple(sorted(changes.items())))


@functools.lru_cache(maxsize=None)
def _inputs_of(arch, seed, changes):
    """The reference's initial params (flat numpy) and the quarter batch
    (whisper's with its encoder frames, as the reference test's)."""
    cfg = _ref_cfg(arch, changes)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(seed)
    quarter = {
        "tokens": rng.integers(0, cfg.vocab, (BQ, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (BQ, S)).astype(np.int32),
        "weights": np.ones((BQ, S), np.float32),
        "denom": np.float32(BQ * S),
    }
    if cfg.is_encdec:
        quarter["enc_frames"] = rng.normal(
            size=(BQ, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return flat, quarter


def _reference(case):
    """One step of the reference's single-device ``make_train_step`` on
    the quarter → (loss, grad_norm, flat params); an ``@sp`` case shares
    its non-SP twin's (the single-device step has no sequence axis to
    split)."""
    arch, tcfg, seed, changes = _case(case)
    tcfg = {k: v for k, v in tcfg.items() if k != "seq_shard_activations"}
    return _reference_of(arch, tuple(sorted(tcfg.items())), seed,
                         tuple(sorted(changes.items())))


@functools.lru_cache(maxsize=None)
def _reference_of(arch, tcfg, seed, changes):
    cfg = _ref_cfg(arch, changes)
    flat, quarter = _inputs_of(arch, seed, changes)
    rtcfg = RefTrainConfig(**dict(tcfg))
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
            arch, tcfg, _, changes = _case(name)
            flat, quarter = _inputs(name)
            full = {k: (v if np.ndim(v) == 0 else
                        np.tile(v, (groups,) + (1,) * (np.ndim(v) - 1)))
                    for k, v in quarter.items()}
            cases.append(dict(arch=arch, tcfg=tcfg, params=flat, batch=full,
                              pods=pods, data=data, tp=tp, changes=changes))
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
