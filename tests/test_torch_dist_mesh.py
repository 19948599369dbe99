"""The port's mesh over ranks: ``DistMesh`` against ``OneCardMesh``.

The counterpart of ``tests/test_multidevice_collectives.py``: the ranks
of ``repro_torch.dist.launch.run_ranks`` (gloo on the CPU) run the
coded decode's three calls — the λ-weighted f32 sum, and the quantized
hop in int8, int4 and fp8 — at (pod 2, data 2, model 1), where every
group has a rank of its own, and at (1, 1, 2), where every rank runs
every group in turn beside a "model" axis.  Each must equal the
one-card mesh: 0 difference for the f32 sums, the same bits for the
decoded hop and the EF residual rows.  The (1, 1, 2) world also holds
``ShardCtx``'s collectives (and their gradients) against numpy, the
greedy tie rule, and ``shard_params`` → ``gather_params`` for every
dense config, and the optimizer's reductions on slices.  One world per
layout serves every case.
"""
import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro_torch.dist.launch import RankError, run_ranks
from repro_torch.dist.sharding import ShardCtx

# layout (ranks on the pod, data and model axes) → (pods, data, tp, world)
LAYOUTS = {"pod2-data2-model1": (2, 2, 1, 4),
           "pod1-data1-model2": (2, 2, 2, 2)}


@pytest.fixture(scope="module")
def worlds():
    """layout → (each rank's output, the one-card mesh's decodes)."""
    out = {}
    for name, (pods, data, tp, world) in LAYOUTS.items():
        out[name] = (run_ranks(ranks.mesh_world, world,
                               args=(pods, data, tp), timeout=300),
                     ranks.one_card_decodes(pods, data))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ("f32",) + ranks.MODES)
def test_dist_mesh_equals_one_card(worlds, layout, kind):
    per_rank, want = worlds[layout]
    for r, got in enumerate(per_rank):
        for i, (a, b) in enumerate(zip(got["decodes"][kind], want[kind])):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), (layout, kind, r, i,
                                          float(np.abs(a - b).max()))


def test_rank_coordinates(worlds):
    """Rank (p · data_ranks + d) · tp + m, model fastest."""
    coords = [o["coords"] for o in worlds["pod2-data2-model1"][0]]
    assert coords == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    coords = [o["coords"] for o in worlds["pod1-data1-model2"][0]]
    assert coords == [(0, 0, 0), (0, 0, 1)]


def test_shard_ctx_collectives_against_numpy(worlds):
    per_rank, _ = worlds["pod1-data1-model2"]
    tp = len(per_rank)
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
          for r in range(tp)]
    w = np.arange(6 * tp, dtype=np.float32).reshape(2, -1)
    for r, o in enumerate(per_rank):
        assert o["axis_index"] == r
        np.testing.assert_array_equal(o["psum"], sum(xs))
        np.testing.assert_array_equal(
            o["pmax"], np.max([x - 10 * q for q, x in enumerate(xs)], 0))
        np.testing.assert_array_equal(o["all_gather0"], np.concatenate(xs))
        np.testing.assert_array_equal(o["all_gather1"],
                                      np.concatenate(xs, -1))
        # JAX's transposes: psum → psum of the cotangents (2 from each
        # rank); tiled all_gather → the summed cotangent's own block
        np.testing.assert_array_equal(o["psum_grad"], np.full((2, 3),
                                                              2.0 * tp))
        np.testing.assert_array_equal(o["gather_grad"],
                                      tp * w[:, 3 * r:3 * (r + 1)])


def test_greedy_ties_take_the_lowest_index(worlds):
    per_rank, _ = worlds["pod1-data1-model2"]
    tp, V = len(per_rank), 4
    for o in per_rank:
        # a tie inside every block → rank 0's first; across blocks →
        # rank 0's; a max on the last rank only → its global index
        np.testing.assert_array_equal(o["argmax"], [1, 2, (tp - 1) * V])
        np.testing.assert_array_equal(o["argmax_full"], [1, 2, 0])


def test_shard_and_gather_params_round_trip(worlds):
    per_rank, _ = worlds["pod1-data1-model2"]
    for o in per_rank:
        assert o["round_trip"] == []


def test_optimizer_reductions_span_the_ranks(worlds):
    """The global norm, the clip, adafactor's factored statistics and its
    update RMS on a rank's slices equal the same on the whole leaves
    (float32 rounding): left local, the norm is a rank's and adafactor's
    row/column means a slice's."""
    per_rank, _ = worlds["pod1-data1-model2"]
    for o in per_rank:
        opt = o["optimizer"]
        assert opt["norm"] < 1e-6, opt
        assert opt["clip"] < 1e-7, opt
        assert opt["adafactor"] < 1e-6 and opt["adamw"] < 1e-6, opt


def test_inactive_ctx_is_the_identity():
    import torch

    ctx = ShardCtx()
    x = torch.randn(3, 4)
    for y in (ctx.psum(x), ctx.pmax(x), ctx.all_gather(x),
              ctx.local_block(x, 2), ctx.reduce_sum(x)):
        assert y is x
    assert ctx.axis_index() == 0
    assert ctx.argmax(x, 4).tolist() == x.argmax(-1).tolist()


def test_failed_rank_raises_its_traceback():
    """Rank 1 raises while rank 0 waits on it in a collective: the
    parent raises rank 1's traceback and leaves no rank running."""
    with pytest.raises(RankError, match="(?s)rank 1 of 2.*ZeroDivisionError"):
        run_ranks(ranks.divide, 2, args=(0,), timeout=120)
