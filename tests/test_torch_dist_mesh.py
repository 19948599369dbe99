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
sequence-parallel helpers (``gather_seq``, ``scatter_seq``,
``psum_scatter``: values, a round trip, and each gradient against the
transpose JAX takes of the same SPMD map), the greedy tie rule, and
``shard_params`` → ``gather_params`` for all ten configs (the expert,
conv and SSM-head leaves too), and the optimizer's reductions on slices.
One world per layout serves every case.
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


SP_SHAPE = (2, 8, 3)  # (B, S, d) of ranks.sp_helpers


def test_sp_helpers_against_numpy(worlds):
    per_rank, _ = worlds["pod1-data1-model2"]
    tp = len(per_rank)
    B, S, d = SP_SHAPE
    Sl = S // tp
    local = [np.arange(B * Sl * d, dtype=np.float32).reshape(B, Sl, d)
             * (r + 1) for r in range(tp)]
    full = [np.arange(B * S * d, dtype=np.float32).reshape(B, S, d)
            * (r + 1) for r in range(tp)]
    for r, o in enumerate(per_rank):
        sp = o["sp"]
        block = slice(r * Sl, (r + 1) * Sl)
        np.testing.assert_array_equal(sp["gather"], np.concatenate(local, 1))
        np.testing.assert_array_equal(sp["scatter"], full[r][:, block])
        np.testing.assert_array_equal(sp["psum_scatter"],
                                      sum(full)[:, block])
        np.testing.assert_array_equal(sp["round_trip"], local[r])
        # without seq_shard: identities, and psum_scatter is psum
        assert sp["off"] == [True, True, True]
        assert "divisible by tp=2" in sp["bad_len"]


def _sp_transpose(kind, tp):
    """The transpose JAX takes of a helper, as the linear map from every
    rank's operand to every rank's output (stacked on a leading rank
    axis), applied to the ranks' cotangents → each rank's gradient."""
    import jax
    import jax.numpy as jnp

    B, S, d = SP_SHAPE
    Sl = S // tp
    if kind == "gather":  # tiled all-gather on the sequence axis
        def f(X):
            return jnp.stack([jnp.concatenate(list(X), axis=1)] * tp)
        shape = (tp, B, Sl, d)
    elif kind == "scatter":  # each rank's static slice of its own copy
        def f(X):
            return jnp.stack([X[r][:, r * Sl:(r + 1) * Sl]
                              for r in range(tp)])
        shape = (tp, B, S, d)
    else:  # psum, then each rank's block
        def f(X):
            tot = X.sum(0)
            return jnp.stack([tot[:, r * Sl:(r + 1) * Sl]
                              for r in range(tp)])
        shape = (tp, B, S, d)
    arg = jax.ShapeDtypeStruct(shape, jnp.float32)
    out = jax.eval_shape(f, arg).shape
    cot = np.stack([ranks.sp_cotangent(out[1:], r) for r in range(tp)])
    (g,) = jax.linear_transpose(f, arg)(jnp.asarray(cot))
    return np.asarray(g)


@pytest.mark.parametrize("kind", ["gather", "scatter", "psum_scatter"])
def test_sp_helper_gradients_are_the_jax_transposes(worlds, kind):
    """gather_seq ↔ reduce-scatter, psum_scatter ↔ all-gather, and
    scatter_seq's slice → a zero-padded scatter with no collective."""
    per_rank, _ = worlds["pod1-data1-model2"]
    want = _sp_transpose(kind, len(per_rank))
    for r, o in enumerate(per_rank):
        np.testing.assert_array_equal(o["sp"][kind + "_grad"], want[r])


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
    (float32 rounding), for the dense, expert, SSD and RG-LRU leaves:
    left local, the norm is a rank's and adafactor's row/column means a
    slice's."""
    per_rank, _ = worlds["pod1-data1-model2"]
    for o in per_rank:
        assert set(o["optimizer"]) == set(ranks.OPT_ARCHS)
        for arch, opt in o["optimizer"].items():
            assert opt["norm"] < 1e-6, (arch, opt)
            assert opt["clip"] < 1e-7, (arch, opt)
            assert opt["adafactor"] < 1e-6 and opt["adamw"] < 1e-6, \
                (arch, opt)


def test_inactive_ctx_is_the_identity():
    import torch

    ctx = ShardCtx()
    x = torch.randn(3, 4)
    for y in (ctx.psum(x), ctx.pmax(x), ctx.all_gather(x),
              ctx.local_block(x, 2), ctx.reduce_sum(x), ctx.gather_seq(x),
              ctx.scatter_seq(x), ctx.psum_scatter(x)):
        assert y is x
    assert ShardCtx(seq_shard=True).gather_seq(x) is x  # tp 1: no SP
    assert ShardCtx(tp=2, seq_shard=True).no_sp() == ShardCtx(tp=2)
    assert ctx.axis_index() == 0
    assert ctx.argmax(x, 4).tolist() == x.argmax(-1).tolist()


def test_failed_rank_raises_its_traceback():
    """Rank 1 raises while rank 0 waits on it in a collective: the
    parent raises rank 1's traceback and leaves no rank running."""
    with pytest.raises(RankError, match="(?s)rank 1 of 2.*ZeroDivisionError"):
        run_ranks(ranks.divide, 2, args=(0,), timeout=120)
