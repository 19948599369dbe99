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
from repro_torch.configs.registry import get_config
from repro_torch.dist import sharding
from repro_torch.dist.launch import run_ranks
from repro_torch.launch import dryrun, op_analysis, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from torch_reference import few_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def real():
    return run_ranks(ranks.tally_run, 2, timeout=300)


TALLIED = ["train", "train-sp", "train-sbo", "train-fsdp",
           "train-fsdp-accum", "serve"]


def _counted(name):
    tally = sharding.CollectiveTally()
    group = sharding.CountingGroup(2, (0, 1), 450e9, tally)
    ctx = sharding.ShardCtx(tp=2, rank=0, group=group)
    ranks.tally_steps(ctx, "meta")[name]()
    return {k: (v["count"], v["operand_bytes"], v["link_bytes"])
            for k, v in tally.by_kind.items()}


@pytest.mark.parametrize("name", TALLIED)
def test_counting_group_tallies_equal_real_world(real, name):
    got = _counted(name)
    for r in real:
        assert r[name] == got
    assert got["all-reduce"][0] > 0
    if name == "train-sp":
        assert got["all-gather"][0] > 0 and got["reduce-scatter"][0] > 0
    if name.startswith("train-fsdp"):
        # one gather a split leaf at entry; one reduce-scatter of its
        # gradient, or one a microbatch with sharded_accum
        split = sum(ax is not None for ax in sharding.data_axes(
            ranks.f32_cfg("llama3-8b"), 2).values())
        micro = ranks.TALLY_B if name.endswith("accum") else 1
        assert got["all-gather"][0] == split
        assert got["reduce-scatter"][0] == micro * split


def test_save_block_outputs_equals_full_remat(real):
    """``remat_policy="save_block_outputs"`` at tp 2: the loss and every
    gradient leaf equal the ``"full"`` remat's bit for bit (float32), and
    the step runs one all-reduce a layer fewer: the recomputed forward's
    attention psum (the MLP's is the layer's last op, which the
    recompute never reaches: it stops once the backward's saved tensors
    are back); the backward's psums stay."""
    for r in real:
        full, sbo = r["grads"]["full"], r["grads"]["save_block_outputs"]
        assert full[0] == sbo[0]
        for a, b in zip(full[1], sbo[1]):
            np.testing.assert_array_equal(a, b)
    layers = ranks.f32_cfg("llama3-8b").n_layers
    full, sbo = real[0]["train"], real[0]["train-sbo"]
    assert full["all-reduce"][0] - sbo["all-reduce"][0] == layers
    assert {k: v for k, v in full.items() if k != "all-reduce"} == \
        {k: v for k, v in sbo.items() if k != "all-reduce"}


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


def _cell(shape, **kw):
    rec = aot.run_cell("llama3-8b", shape, verbose=False, microbatch=0,
                       **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


def _counts(rec):
    return {k: v["count"] for k, v in rec["collectives"].items()}


@pytest.fixture(scope="module")
def no_fsdp():
    """The llama3-8b train_4k cell without FSDP (tp 16 × dp 16, one
    microbatch a rank): the yardstick of the layouts below."""
    return _cell("train_4k", fsdp=False)


@pytest.mark.parametrize("kw", [dict(), dict(mode="dp_only"),
                                dict(moe_ep_axis="data")])
def test_untrained_layouts_are_errors(kw, no_fsdp):
    """The layouts the port trains since FSDP came (the name is the
    first dry run's, which refused them): the reference's default
    ``fsdp=True``, ``mode="dp_only"`` (FSDP over "data" × "model", no
    TP) and experts over "data" return ``ok`` with counted collectives:
    one all-gather over the FSDP ranks a split leaf (on top of the
    embedding's TP gather), one reduce-scatter of its gradient, and its
    all-reduce over the data-parallel ranks gone (two all-reduces more
    for the clip's norm over the FSDP ranks); the rank holds its blocks,
    so its arguments shrink while its peak holds the whole copies."""
    arch = "llama4-maverick-400b-a17b" if "moe_ep_axis" in kw \
        else "llama3-8b"
    rec = aot.run_cell(arch, "train_4k", verbose=False, microbatch=0, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    split = rec["fsdp_leaves"]
    assert split > 0
    got = _counts(rec)
    mem = rec["memory_analysis"]
    if arch == "llama3-8b" and not kw:
        want = _counts(no_fsdp)
        assert got["all-gather"] == want["all-gather"] + split
        assert got["reduce-scatter"] == want["reduce-scatter"] + split
        assert got["all-reduce"] == want["all-reduce"] - split + 2
        base = no_fsdp["memory_analysis"]
        assert mem["argument_bytes"] < base["argument_bytes"]
        assert mem["peak_bytes"] - mem["argument_bytes"] > \
            base["peak_bytes"] - base["argument_bytes"]
    if kw.get("mode") == "dp_only":
        assert rec["tp"] == 1 and rec["dp"] == rec["n_devices"]
        # no TP: every all-gather and reduce-scatter is FSDP's
        assert got["all-gather"] == got["reduce-scatter"] == split
    if "moe_ep_axis" in kw:
        # the 128 experts split 16 ways on their expert dim, whole on
        # "model"
        cfg = get_config(arch)
        want = sharding.fsdp_splits(cfg, {"data": 16}, moe_ep_axis="data")
        experts = [k for k in want if k.rsplit("/", 1)[-1] in
                   ("we_g", "we_u", "we_d")]
        assert experts and all(want[k] == (-3, ("data",)) for k in experts)
        tp_axes = sharding.param_axes(cfg, rec["tp"], "data")
        assert all(tp_axes[k] is None for k in experts)
        assert got["reduce-scatter"] >= split


@pytest.mark.parametrize("kw", [dict(flash=True), dict(sharded_accum=True),
                                dict(remat_policy="save_block_outputs")])
def test_options_without_behaviour_are_errors(kw, no_fsdp):
    """The reference's options (the name is the first dry run's, which
    refused them): ``flash=True`` counts the step the port always runs
    (the same collectives and FLOPs as without it); ``sharded_accum``
    reduce-scatters each microbatch's gradient of a split leaf (two
    microbatches a rank here: one reduce-scatter a split leaf more than
    one reduction of the accumulated gradient); ``save_block_outputs``
    keeps each layer's attention psum out of its recompute (the MLP's,
    the layer's last op, is past where the recompute stops once the
    backward's saved tensors are back, under either policy)."""
    rec = aot.run_cell("llama3-8b", "train_4k", verbose=False,
                       microbatch=0 if "sharded_accum" not in kw else 128,
                       fsdp=False if "remat_policy" in kw else True, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    got = _counts(rec)
    if "flash" in kw:
        base = _cell("train_4k")
        assert got == _counts(base)
        assert rec["matmul_flops"] == base["matmul_flops"]
    if "sharded_accum" in kw:
        split = rec["fsdp_leaves"]
        assert rec["rows_per_rank"] == 16
        assert got["reduce-scatter"] >= 2 * split
        plain = aot.run_cell("llama3-8b", "train_4k", verbose=False,
                             microbatch=128)
        assert got["reduce-scatter"] - _counts(plain)["reduce-scatter"] \
            == split
    if "remat_policy" in kw:
        layers = get_config("llama3-8b").n_layers
        want = _counts(no_fsdp)
        assert want["all-reduce"] - got["all-reduce"] == layers
        assert rec["matmul_flops"] == no_fsdp["matmul_flops"]


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
