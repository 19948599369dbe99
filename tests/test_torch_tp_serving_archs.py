"""Serving the MoE, SSM, RG-LRU and encoder–decoder configs at tp 2
(ranks of ``dist.launch.run_ranks``, gloo on the CPU):

  * granite-moe-3b-a800m and llama4-maverick (expert-parallel, the bulk
    prefill), mamba2-370m and recurrentgemma-2b (each rank's recurrent
    states over its heads or channels, the exact handoff) and
    whisper-medium (the encoder at a rank's heads filling a per-rank
    cross cache) in float32: greedy tokens equal to the reference's at
    tp 1 (``repro.api.serving.generate``; its serve CLI's own tp-2 test
    fails on this tree, ROADMAP.md §3) and forward logits within
    ``tests/test_torch_transformer.py``'s tolerance;
  * each of them at its smoke config through every entry point at tp 2:
    ``init_params`` gives the slices of the tp-1 shapes, ``init_cache``
    builds, a coded session builds and steps (whisper's coded batches
    carry no frames, so it only builds, as at tp 1), and the serve CLI
    at ``--tp 2`` serves, every rank the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import transformer as jtf
from repro_torch.dist.launch import run_ranks

TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_transformer.py's, on logits
GEN, MAX_LEN, TP = 12, 32, 2
ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
         "mamba2-370m", "recurrentgemma-2b", "whisper-medium"]


def _inputs(arch, i):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(31 + i), cfg)
    rng = np.random.default_rng(32 + i)
    # 16 tokens: a whole number of the smoke SSD's 8-token chunks
    prompt = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    frames = (rng.normal(size=(2, cfg.enc_len, cfg.d_model))
              .astype(np.float32) if cfg.is_encdec else None)
    return cfg, params, prompt, frames


@pytest.fixture(scope="module")
def served():
    """arch → (reference tokens and logits, each rank's)."""
    cases, want = [], []
    for i, arch in enumerate(ARCHS):
        cfg, params, prompt, frames = _inputs(arch, i)
        jframes = None if frames is None else jnp.asarray(frames)
        toks = jserving.generate(params, cfg, prompt, GEN, max_len=MAX_LEN,
                                 enc_frames=jframes)
        logits, _ = jtf.forward(params, cfg, prompt, enc_frames=jframes)
        want.append((np.asarray(toks), np.asarray(logits)))
        cases.append(dict(arch=arch, prompt=prompt, gen=GEN, max_len=MAX_LEN,
                          exact=False, enc_frames=frames,
                          params={k: np.asarray(v) for k, v in
                                  _flatten(params).items()}))
    got = run_ranks(ranks.serve_cases, TP, args=(cases, TP), timeout=300)
    return {arch: (want[n], [g[n] for g in got])
            for n, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_serving_matches_reference_tp1(served, arch):
    (toks, logits), per_rank = served[arch]
    for got in per_rank:  # every rank decodes the same tokens
        np.testing.assert_array_equal(got["tokens"], toks)
        np.testing.assert_allclose(got["logits"], logits, **TOL)


@pytest.fixture(scope="module")
def entry_points():
    """Each rank's checks of ``ranks.archs_at_tp``."""
    return run_ranks(ranks.archs_at_tp, TP, args=(ARCHS, TP), timeout=600)


@pytest.mark.parametrize("arch", ARCHS)
def test_archs_run_under_tp(entry_points, arch):
    mine = [o[arch] for o in entry_points]
    for o in mine:
        assert o["bad_shapes"] == [] and o["split"] > 0, o
        assert np.isfinite(o["losses"]).all()
        assert len(o["losses"]) == (0 if arch == "whisper-medium" else 1)
        assert o["tokens"].shape == (4, 4)
        np.testing.assert_array_equal(o["tokens"], mine[0]["tokens"])
