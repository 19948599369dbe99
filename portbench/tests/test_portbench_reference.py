"""The plain reference agrees with the port at a tiny size on the CPU:
the model's logits and losses, a training cell's first steps and a
serving cell's tokens, each with the port in float32."""
from __future__ import annotations

import pytest
import torch

from portbench import check, data, weights
from portbench.reference import model as ref
from portbench.tests import portbench_tiny as tiny


def _port_forward(m, W, tokens):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tf

    cfg = ModelConfig(**m)
    logits, aux = tf.forward(weights.nest(W), cfg, tokens)
    return logits, aux


@pytest.mark.parametrize("m", [dict(tiny.DENSE, dtype="float32"),
                               dict(tiny.MOE, dtype="float32")],
                         ids=["dense", "moe"])
def test_reference_logits_match_the_port(m):
    W = {k: weights.draw(k, s, 5, "cpu", torch.float32)
         for k, s in weights.param_shapes(m).items()}
    tokens = torch.from_numpy(data.part_tokens(5, 0, 0, 3, 24,
                                               m["vocab"])[0])
    want, aux_port = _port_forward(m, W, tokens)
    x, aux = ref.hidden(W, m, tokens)
    got = ref.logits(W, m, x)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    assert float(aux) == pytest.approx(float(aux_port), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("cf", [0.5, 1.25], ids=["drops", "cf1.25"])
def test_reference_expert_layer_matches_the_port(cf):
    """Routing, capacity drops in token order, the batched experts and
    the load-balancing loss, against the port's layer."""
    from repro_torch.models import moe as moe_lib

    m = dict(tiny.MOE, capacity_factor=cf)
    E, d, ff = m["n_experts"], m["d_model"], m["d_ff"]
    gen = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(d, E, generator=gen),
         "we_g": torch.randn(E, d, ff, generator=gen) * 0.1,
         "we_u": torch.randn(E, d, ff, generator=gen) * 0.1,
         "we_d": torch.randn(E, ff, d, generator=gen) * 0.1}
    h = torch.randn(2, 24, d, generator=gen)
    want, aux_want = moe_lib.moe_ffn(p, h, m["top_k"], cf)
    got, aux = ref.moe({"moe." + k: v for k, v in p.items()}, h, m, "")
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert float(aux) == pytest.approx(float(aux_want), rel=1e-6)


@pytest.mark.parametrize("name", ["granite8b.train_s512",
                                  "granitemoe.train_s1024"])
def test_training_cell_first_steps_match_in_float32(name):
    out = tiny.run(tiny.cell(name, dtype="float32"))
    values = {k: v["value"] for k, v in out["checks"].items()}
    # f32 on both sides, the reference following the int8 hop: only the
    # order of float32 sums differs
    assert values["loss_gap"] < 1e-6
    assert values["grad_gap"] < 1e-4
    assert values["change_gap"] < 1e-4
    assert out["attempted"] > 0 and out["failed"] == 0


def test_serving_cell_tokens_match_in_float32():
    out = tiny.run(tiny.cell("granite8b.serve_code", dtype="float32"))
    assert out["checks"]["logit_gap"]["value"] < 1e-4
    assert out["attempted"] > 0 and out["failed"] == 0
    assert check.correct(out["checks"])
