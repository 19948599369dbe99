"""Pipeline parallelism of the port, part one: the stage helpers against
the reference's, the mesh's "stage" axis, and the dist step at pp 2
against the reference's single-device step for the five dense configs.

  * ``validate_pp`` and ``stage_layer_ranges`` give the reference's
    values and messages (its ``tests/test_pp_parity.py`` cases);
  * ``DistMesh`` at (stage 2, pod 2, data 2) and at (stage 2, model 2)
    decodes exactly as ``OneCardMesh`` on every rank, numbers its ranks
    stage first, hands tensors to the next stage and back (float32,
    bfloat16, fp8 as bytes), and sums over the stage group; at (stage
    2, model 2) ``init_params(pp=, stage=)`` gives the slices of the
    pp-1 draws, ``shard_params`` → ``gather_params`` round-trips every
    leaf, and the global norm, the clip and one adafactor and one adamw
    update on a rank's slices (split on both axes) equal the same on the
    whole leaves;
  * llama3-8b, granite-8b (4 layers), starcoder2-3b, gemma3-27b (14
    layers) and qwen2-vl-2b at pp 2, 2 microbatches, every (pod, data)
    group in turn on each rank (``tests/torch_pp_parity.py``).
"""
import dataclasses

import numpy as np
import pytest

import torch_pp_parity as parity
import torch_tp_ranks as ranks
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.dist import sharding as jsharding
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import sharding
from repro_torch.dist.launch import run_ranks

LAYOUTS = ["stage2-archs-a"]
BAD_PP = [("granite-8b", 2, 0, 0), ("llama3-8b", 2, 3, 4),
          ("gemma3-27b", 2, 0, 0), ("llama3-8b", 3, 2, 5)]


@pytest.fixture(scope="module")
def port_steps():
    return parity.port_steps(LAYOUTS)


@pytest.mark.parametrize("layout,case", [(w, c) for w in LAYOUTS
                                         for c in parity.WORLDS[w][4]])
def test_pp_step_matches_reference_single_device(port_steps, layout, case):
    parity.check(port_steps[(layout, case)], case)


@pytest.mark.parametrize("arch,pp,micro,rows", BAD_PP,
                         ids=[f"{a}-pp{p}-m{m}-rows{r}"
                              for a, p, m, r in BAD_PP])
def test_validate_pp_messages_match_reference(arch, pp, micro, rows):
    with pytest.raises(ValueError) as want:
        jsharding.validate_pp(ref_smoke(arch), pp, microbatches=micro,
                              batch_rows=rows)
    with pytest.raises(ValueError) as got:
        sharding.validate_pp(get_smoke_config(arch), pp,
                             microbatches=micro, batch_rows=rows)
    assert str(got.value) == str(want.value)
    assert "divisib" in str(got.value)


def test_validate_pp_accepts_what_the_reference_accepts():
    for arch, pp, kw in (("granite-8b", 3, {}), ("llama3-8b", 2, {}),
                         ("llama3-8b", 2, dict(microbatches=2,
                                               batch_rows=4)),
                         ("llama3-8b", 1, dict(microbatches=3,
                                               batch_rows=4))):
        jsharding.validate_pp(ref_smoke(arch), pp, **kw)
        sharding.validate_pp(get_smoke_config(arch), pp, **kw)


@pytest.mark.parametrize("arch,layers,pp", [
    ("gemma3-27b", 14, 2), ("llama3-8b", 0, 2), ("llama3-8b", 0, 1),
    ("recurrentgemma-2b", 8, 2), ("whisper-medium", 0, 2)])
def test_stage_layer_ranges_match_reference(arch, layers, pp):
    mine, theirs = get_smoke_config(arch), ref_smoke(arch)
    if layers:
        mine = dataclasses.replace(mine, n_layers=layers)
        theirs = dataclasses.replace(theirs, n_layers=layers)
    got = sharding.stage_layer_ranges(mine, pp)
    assert got == jsharding.stage_layer_ranges(theirs, pp)
    if arch == "gemma3-27b":
        assert got == ((0, 6), (6, 14))  # the last stage owns the rest


def test_stage_axes_split_only_the_group_stacks():
    cfg = get_smoke_config("whisper-medium")
    axes = sharding.stage_axes(cfg, 2)
    assert axes["groups/p0/attn/wq"] == -4 + 1  # (G, d, H·Dh): axis 0
    for k, ax in axes.items():
        assert (ax is not None) == k.startswith("groups/"), k
    assert not any(sharding.stage_axes(cfg, 1).values())
    assert sharding.stage_sharded_mask(cfg, 2)["groups/p0/norm1/scale"]


# layout → (pods, data, tp, pp, world)
MESHES = {"stage2-pod2-data2": (2, 2, 1, 2, 8),
          "stage2-model2": (2, 2, 2, 2, 4)}


@pytest.fixture(scope="module")
def meshes():
    out = {}
    for name, (pods, data, tp, pp, world) in MESHES.items():
        out[name] = (run_ranks(ranks.pp_mesh_world, world,
                               args=(pods, data, tp, pp), timeout=300),
                     ranks.one_card_decodes(pods, data))
    return out


@pytest.mark.parametrize("layout", list(MESHES))
@pytest.mark.parametrize("kind", ("f32",) + ranks.MODES)
def test_stage_mesh_equals_one_card(meshes, layout, kind):
    per_rank, want = meshes[layout]
    for r, got in enumerate(per_rank):
        for i, (a, b) in enumerate(zip(got["decodes"][kind], want[kind])):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), (layout, kind, r, i)


def test_stage_mesh_coordinates_handoff_and_sum(meshes):
    """Rank ((s · pod_ranks + p) · data_ranks + d) · tp + m, stage
    slowest; each handoff delivers the adjacent stage's tensor of the
    same (pod, data, model) coordinates, bit for bit."""
    outs = meshes["stage2-pod2-data2"][0]
    assert [o["coords"] for o in outs] == [
        (s, p, d, 0) for s in range(2) for p in range(2) for d in range(2)]
    outs = meshes["stage2-model2"][0]
    assert [o["coords"] for o in outs] == [
        (s, 0, 0, m) for s in range(2) for m in range(2)]
    for name, (_, _, _, pp, world) in MESHES.items():
        outs = meshes[name][0]
        per_stage = world // pp
        for r, o in enumerate(outs):
            st = o["coords"][0]
            np.testing.assert_array_equal(o["stage_sum"], [2.0, 1.0])
            for dt, got in o["handoff"].items():
                base = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
                if st > 0:  # from the previous stage, rank r − per_stage
                    want = base + 100 * (st - 1) + 10 * (r - per_stage)
                    np.testing.assert_array_equal(
                        got["fwd"], _round(want, dt), err_msg=dt)
                if st + 1 < pp:
                    want = base + 100 * (st + 1) + 10 * (r + per_stage)
                    np.testing.assert_array_equal(
                        got["bwd"], _round(want, dt), err_msg=dt)


def _round(x, dt):
    import torch

    return torch.from_numpy(x).to(getattr(torch, dt.split(".")[-1])) \
        .float().numpy()


def test_stage_shard_round_trip_and_optimizer_reductions(meshes):
    for r, o in enumerate(meshes["stage2-model2"][0]):
        assert o["round_trip"] == [], (r, o["round_trip"][:5])
        for arch, res in o["optimizer"].items():
            assert res["norm"] < 1e-6, (arch, res)
            assert res["clip"] < 1e-6, (arch, res)
            for k in ("adafactor", "adamw", "adafactor_state",
                      "adamw_state"):
                assert res[k] < 1e-6, (arch, k, res)
