"""The dry run's counting machinery and its CLI on the CPU:

  * at tp 2 the counting group's per-kind collective counts, operand
    bytes and link bytes over one rank's step on the ``meta`` device
    equal what a real 2-rank gloo world tallies over the same step
    (``dist.sharding.TALLY``): a train step, the same with sequence
    parallelism, and a served request (prefill and 2 greedy tokens);
  * ``launch.steps.make_train_step``'s step on one rank's slices (tp 2;
    tp 2 with sequence parallelism; tp 2 × 2 data ranks averaging the
    gradients: the dry run's train step) equals the tp-1 step, over 4
    gloo ranks: the loss and every gathered param;
  * the op counter's live bytes follow each storage from its allocation
    to its last reference, and arguments updated in place allocate
    nothing;
  * ``python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
    decode_32k`` and a ``--multi-pod --no-fsdp`` train cell
    (recurrentgemma-2b, the quickest to count) return ``ok`` with the
    reference's record keys; the layouts the port does not train
    (``fsdp``, ``dp_only``, experts over "data") and the options with
    nothing behind them in the port (``flash``, ``sharded_accum``,
    ``remat_policy``) return ``error`` naming ROADMAP.md.
"""
import json

import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro_torch import _tree
from repro_torch.api import aot
from repro_torch.checkpoint.params import _flatten, params_from_numpy
from repro_torch.dist import sharding
from repro_torch.dist.launch import run_ranks
from repro_torch.launch import dryrun, op_analysis, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from torch_reference import few_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def real():
    return run_ranks(ranks.tally_run, 2, timeout=300)


@pytest.mark.parametrize("name", ["train", "train-sp", "serve"])
def test_counting_group_tallies_equal_real_world(real, name):
    tally = sharding.CollectiveTally()
    group = sharding.CountingGroup(2, (0, 1), 450e9, tally)
    ctx = sharding.ShardCtx(tp=2, rank=0, group=group)
    ranks.tally_steps(ctx, "meta")[name]()
    got = {k: (v["count"], v["operand_bytes"], v["link_bytes"])
           for k, v in tally.by_kind.items()}
    for r in real:
        assert r[name] == got
    assert got["all-reduce"][0] > 0
    if name == "train-sp":
        assert got["all-gather"][0] > 0 and got["reduce-scatter"][0] > 0


DP_B, DP_S = 4, 16


@pytest.fixture(scope="module")
def dp_world():
    """The llama3-8b float32 smoke params and a batch, and what a world
    of 4 gloo ranks makes of them (``torch_tp_ranks.dp_train_run``)."""
    cfg = ranks.f32_cfg("llama3-8b")
    full = tf.init_params(cfg, torch.Generator().manual_seed(4),
                          device="cpu", dtype=torch.float32)
    flat = {k: v.numpy() for k, v in _flatten(full).items()}
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (DP_B, DP_S)),
             "targets": rng.integers(0, cfg.vocab, (DP_B, DP_S)),
             "weights": np.ones((DP_B, DP_S), np.float32)}
    got = run_ranks(ranks.dp_train_run, 4, args=(flat, batch),
                    timeout=300)[0]
    return cfg, flat, batch, got


@pytest.mark.parametrize("case", list(ranks.DP_CASES))
def test_parallel_train_step_equals_tp1(dp_world, case):
    """``make_train_step`` under a "model" ctx of 2 (with sequence
    parallelism; and averaged over 2 data ranks, each with half the
    rows) against the same step at tp 1 on the whole batch: one sgd step
    of the float32 smoke llama3-8b, unclipped, the loss within 1e-5 relative and
    every gathered param within 3e-5 (the tp train parity bound)."""
    cfg, flat, batch, got = dp_world
    params = params_from_numpy(flat, "cpu")
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    step = steps.make_train_step(cfg, ranks.DP_TCFG)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    whole["tokens"], whole["targets"] = (whole["tokens"].long(),
                                         whole["targets"].long())
    params, _, metrics = step(params, step.optimizer.init(params), whole, 0)
    want = {k: v.detach().numpy() for k, v in _flatten(params).items()}
    got = got[case]
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert set(got["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=3e-5,
                                   err_msg=f"{case} {k}")


def test_op_counter_tracks_live_storages():
    x = torch.empty(1000, device="meta")  # an argument: 4000 bytes
    w = torch.empty(1000, device="meta")

    def step(x, w):
        y = x * 2.0                 # +4000
        z = (y + 1.0).view(10, 100)  # +4000, a view of the sum
        del y                       # -4000
        w.add_(z.reshape(-1))       # in place on an argument: +0
        return z.sum()              # +4 (z freed after the return)

    counter = op_analysis.OpCounter((x, w))
    with counter:
        out = step(x, w)
    mem = counter.memory_analysis()
    assert mem["argument_bytes"] == 8000
    assert counter.peak == 8000
    assert mem["output_bytes"] == 4 and out.shape == ()
    assert counter.flops == 1000 * 3 + 1000  # three pointwise, one sum


def test_production_mesh_layout():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.rank_of(pod=1, data=2, model=3) == 291
    assert mesh.group_ranks(("model",), 291) == tuple(range(288, 304))
    tally = sharding.CollectiveTally()
    g = mesh.counting_group(mesh.group_ranks(("pod",), 3), tally)
    assert g.ranks == (3, 259) and g.link == 50e9
    assert mesh.counting_group(tuple(range(8)), tally).link == 450e9


def test_dryrun_cli_cells(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "recurrentgemma-2b", "--shape",
                        "train_4k", "--multi-pod", "--no-fsdp", "--out",
                        str(tmp_path)]) == 0
    assert "[dryrun] done: 1 ok, 0 skipped, 0 failed of 1 cells" in \
        capsys.readouterr().out
    rec = json.loads((tmp_path / "recurrentgemma-2b__train_4k__multi.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    for key in ("flops", "bytes_accessed", "bytes_accessed_bf16eq",
                "collectives", "collective_operand_bytes",
                "collective_link_bytes", "collective_link_bytes_bf16eq",
                "cross_pod_link_bytes", "memory_analysis", "roofline"):
        assert key in rec
    # the gradient sum over "pod" x "data" crosses the pods
    assert rec["cross_pod_link_bytes"] > 0
    for key in ("compute_s", "memory_s", "memory_s_pallas", "collective_s",
                "dominant", "useful_flops_ratio", "model_flops_global"):
        assert key in rec["roofline"]
    dec = json.loads((tmp_path / "mamba2-370m__decode_32k__single.json")
                     .read_text())
    assert dec["status"] == "ok" and dec["cross_pod_link_bytes"] == 0


@pytest.mark.parametrize("kw", [dict(), dict(fsdp=False, mode="dp_only"),
                                dict(fsdp=False, moe_ep_axis="data")])
def test_untrained_layouts_are_errors(kw):
    rec = aot.run_cell("mamba2-370m", "train_4k", verbose=False, **kw)
    assert rec["status"] == "error" and "ROADMAP.md §1" in rec["error"]


@pytest.mark.parametrize("kw", [dict(flash=True), dict(sharded_accum=True),
                                dict(remat_policy="save_block_outputs")])
def test_options_without_behaviour_are_errors(kw):
    """The reference's options the port has nothing behind return
    ``error`` (no record of a step that was not counted)."""
    rec = aot.run_cell("mamba2-370m", "decode_32k", verbose=False, **kw)
    assert rec["status"] == "error" and "ROADMAP.md §1" in rec["error"]
    assert "no such option" in rec["error"]


def test_op_counter_counts_composites_under_inference_mode():
    """Under ``inference_mode`` composite ops (``matmul``, ``rms_norm``)
    reach the mode whole; the counter runs their parts, so a served
    prefill counts the same FLOPs, bytes and peak as under ``no_grad``."""
    import dataclasses

    from repro_torch.api import serving
    from repro_torch.configs.registry import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=2)
    params = aot.tf_params(cfg)
    prompt = torch.empty((2, 16), dtype=torch.long, device="meta")
    prefill = serving.make_prefill_fn(cfg, 24)
    seen = []
    for mode in (torch.inference_mode, torch.no_grad):
        counter = op_analysis.OpCounter((params, prompt))
        with mode(), counter:
            prefill(params, prompt)
        seen.append((counter.flops, counter.matmul_flops, counter.bytes,
                     counter.peak, counter.kernels))
    assert seen[0] == seen[1]
    assert seen[0][1] > 0 and seen[0][4]["flash_attention"]["calls"] == 2
