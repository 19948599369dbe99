"""Port vs reference: greedy generation token for token, and the serve CLI.

The same weights (the reference's init, carried across by flat keys)
and the same numpy prompt go through ``repro.api.serving.generate`` and
``repro_torch.api.serving.generate``, in float32 on the CPU.  Greedy
tokens must be identical: both take the first maximum.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import transformer as jtf
from repro_torch.api import serving
from repro_torch.checkpoint.params import params_from_numpy
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve


@pytest.mark.parametrize("exact_handoff", [False, True],
                         ids=["bulk", "exact"])
@pytest.mark.parametrize("gqa", [False, True], ids=["mqa", "gqa"])
def test_greedy_tokens_match_reference(exact_handoff, gqa):
    ref_cfg = dataclasses.replace(ref_smoke("llama3-8b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    if gqa:
        ref_cfg = dataclasses.replace(ref_cfg, n_heads=8, n_kv_heads=2)
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2)
    jparams = jtf.init_params(jax.random.PRNGKey(11), ref_cfg)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(jparams).items()}, "cpu")
    prompt = np.random.default_rng(12).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32)
    want = jserving.generate(jparams, ref_cfg, prompt, 12, max_len=32,
                             exact_handoff=exact_handoff)
    got = serving.generate(params, cfg, prompt, 12, max_len=32,
                           exact_handoff=exact_handoff, device="cpu")
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_is_seeded():
    cfg = get_smoke_config("llama3-8b")
    from repro_torch.models import transformer as tf

    params = tf.init_params(cfg, device="cpu")
    prompt = [[1, 2, 3, 4]]
    a = serving.generate(params, cfg, prompt, 6, greedy=False, seed=3,
                         device="cpu")
    b = serving.generate(params, cfg, prompt, 6, greedy=False, seed=3,
                         device="cpu")
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab)).all()


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "tokens.json"
    res = serve.main(["--device", "cpu", "--f32", "--batch", "3",
                      "--prompt-len", "8", "--gen", "5",
                      "--tokens-out", str(out)])
    toks = json.load(open(out))["tokens"]
    assert np.asarray(toks).shape == (3, 5)
    np.testing.assert_array_equal(res["tokens"], toks)
    assert res["last_logits"].shape == (3, 256)
    assert np.isfinite(res["last_logits"].numpy()).all()
    exact = serve.main(["--device", "cpu", "--f32", "--batch", "3",
                        "--prompt-len", "8", "--gen", "5",
                        "--exact-handoff"])
    np.testing.assert_array_equal(exact["tokens"], toks)
    # tensor parallelism: the CLI spawns its ranks; rank 0 writes the
    # tokens, those of tp 1 in float32
    out2 = tmp_path / "tokens_tp2.json"
    tp2 = serve.main(["--device", "cpu", "--f32", "--batch", "3",
                      "--prompt-len", "8", "--gen", "5", "--tp", "2",
                      "--tokens-out", str(out2)])
    np.testing.assert_array_equal(json.load(open(out2))["tokens"], toks)
    np.testing.assert_array_equal(tp2["tokens"], toks)
    np.testing.assert_allclose(tp2["last_logits"].numpy(),
                               res["last_logits"].numpy(), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="divisibility"):
        serve.main(["--device", "cpu", "--tp", "3"])


def test_serve_cli_layers_cuts_depth():
    """``--layers N`` serves the config's first N layers: the request of
    ``serve.serve`` on that config, at tp 1 and at tp 2."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=1,
                              dtype="float32")
    want = serve.serve(cfg, batch=2, prompt_len=8, gen_len=4, device="cpu")
    argv = ["--device", "cpu", "--f32", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--layers", "1"]
    for extra in ([], ["--tp", "2"]):
        got = serve.main(argv + extra)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["last_logits"].numpy(),
                                   want["last_logits"].numpy(), rtol=0,
                                   atol=1e-5)
    with pytest.raises(SystemExit):
        serve.main(argv[:-1] + ["3"])
