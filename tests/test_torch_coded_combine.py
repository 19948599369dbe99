"""Port vs reference: the coded combine and its dequant variants.

The plain versions the port runs for CPU tensors (``kernels.ref``
through ``kernels.ops``) against the reference's Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them, on the same
numpy inputs: F not a multiple of the Pallas tile (512), R above its
row tile (8).  Then the bulk HGC encode/decode (``ops.encode_messages``
/ ``decode_gradient``) and the tree flattening against the reference,
and the one-card mesh's two-stage decode against a flat sum.
Tolerance: 1e-5 (float32; only the summation order differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hgc import HGCCode as RefCode
from repro.core.topology import Tolerance as RefTol
from repro.core.topology import Topology as RefTopo
from repro.dist import compression as rc
from repro.kernels import coded_combine as pallas
from repro.kernels import ops as rops
from repro_torch import _tree
from repro_torch.core.hgc import HGCCode
from repro_torch.core.topology import Tolerance, Topology
from repro_torch.dist import compression as tc
from repro_torch.dist import grad_sync
from repro_torch.dist.mesh import OneCardMesh
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("R,K,F", [(1, 2, 700), (8, 8, 1030), (13, 5, 96),
                                   (3, 64, 513)])
def test_combine_f32_matches_pallas(R, K, F):
    c, g = _np(R + K, R, K), _np(F, K, F)
    want = pallas.coded_combine(jnp.asarray(c), jnp.asarray(g),
                                interpret=True)
    got = ops.combine(torch.from_numpy(c), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("R,K,F,block", [(1, 2, 64 * 13, 64),
                                         (9, 8, 640, 128),
                                         (13, 3, 256 * 3, 256)])
def test_dequant_combines_match_pallas(mode, R, K, F, block):
    c = _np(1, R, K)
    x = _np(2, K, F)
    payload, scales = [], []
    for k in range(K):  # each row is one pod's quantized partial
        q, s, _ = rc.quantize(jnp.asarray(x[k]), block=block, mode=mode)
        payload.append(q)
        scales.append(s)
    qs, ss = jnp.stack(payload), jnp.stack(scales)
    fn = {"int8": pallas.coded_combine_q, "int4": pallas.coded_combine_q4,
          "fp8": pallas.coded_combine_f8}[mode]
    want = np.asarray(fn(jnp.asarray(c), qs, ss, block=block,
                         interpret=True))
    tq = torch.stack([tc.quantize(torch.from_numpy(x[k]), block=block,
                                  mode=mode)[0] for k in range(K)])
    got = ops.combine_compressed(mode, torch.from_numpy(c), tq,
                                 torch.from_numpy(np.array(ss)),
                                 block=block)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_combine_compressed_rejects_unknown_mode():
    with pytest.raises(ValueError, match="no fused combine"):
        ops.combine_compressed("int2", torch.ones(1, 1),
                               torch.zeros(1, 4, dtype=torch.int8),
                               torch.ones(1, 1), block=4)


@pytest.mark.parametrize("m,s_e,s_w", [((4, 4), 1, 1), ((3, 3, 3), 1, 1),
                                       ((2, 2, 2, 2), 2, 1)])
def test_encode_decode_match_reference_and_recover_the_sum(m, s_e, s_w):
    ref_code = RefCode.build(RefTopo(m), RefTol(s_e, s_w), seed=1)
    code = HGCCode.build(Topology(m), Tolerance(s_e, s_w), seed=1)
    g = _np(5, code.K, 1000)
    msg = grad_sync.encode_messages(code, torch.from_numpy(g))
    ref_msg = rops.encode_messages(ref_code, jnp.asarray(g))
    np.testing.assert_allclose(msg.numpy(), np.asarray(ref_msg), **TOL)
    rng = np.random.default_rng(2)
    fast_e = tuple(sorted(rng.choice(len(m), len(m) - s_e, replace=False)))
    fast_w = [tuple(sorted(rng.choice(m[i], m[i] - s_w, replace=False)))
              for i in range(len(m))]
    dec = grad_sync.decode_gradient(code, msg, fast_e, fast_w)
    ref_dec = rops.decode_gradient(ref_code, ref_msg, fast_e, fast_w)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **TOL)
    np.testing.assert_allclose(dec.numpy(), g.sum(0), rtol=1e-4,
                               atol=1e-4)


def test_flatten_tree_matches_reference_order():
    tree = {"z": _np(0, 3, 2), "a": {"y": _np(1, 4), "b": _np(2, 2, 2)}}
    jt = {"z": jnp.asarray(tree["z"]),
          "a": {"y": jnp.asarray(tree["a"]["y"]),
                "b": jnp.asarray(tree["a"]["b"])}}
    tt = _tree.map(torch.from_numpy, tree)
    flat = ops.flatten_tree(tt)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(rops.flatten_tree(jt)))
    back = ops.unflatten_like(flat, tt)
    for a, b in zip(_tree.leaves(back), _tree.leaves(tt)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("mode", ["none", "int8", "int4", "fp8"])
def test_one_card_mesh_decode_is_the_lambda_weighted_sum(mode):
    """Stage 1 over "data", stage 2 (exact, or the quantized hop with EF)
    over "pod": Σ_ij λ_ij g_ij, up to the codec's rounding."""
    pods, data = 2, 3
    mesh = OneCardMesh(pods, data)
    grads = {(i, j): [torch.from_numpy(_np(10 * i + j, 5, 33)),
                      torch.from_numpy(_np(100 + 10 * i + j, 70))]
             for i in range(pods) for j in range(data)}
    lam = np.random.default_rng(0).random((pods, data)).astype(np.float32)
    lam[1, 2] = 0.0  # a straggler

    def group_fn(i, j):
        return [g.clone() for g in grads[(i, j)]], torch.tensor(float(i + j))

    want = [sum(lam[i, j] * grads[(i, j)][n] for i in range(pods)
                for j in range(data)) for n in range(2)]
    want_loss = sum(lam[i, j] * (i + j) for i in range(pods)
                    for j in range(data))
    if mode == "none":
        got, loss = grad_sync.coded_weighted_psum(mesh, group_fn, lam)
        tol = 1e-5
    else:
        res = _tree.leaves(tc.init_pod_residuals(
            [g for g in grads[(0, 0)]], pods))
        got, loss = grad_sync.compressed_coded_psum(mesh, group_fn, lam, res,
                                                    block=32, mode=mode)
        tol = {"int8": 3e-2, "int4": 0.5, "fp8": 0.2}[mode]
        # the residual carries exactly what the payloads did not
        for n in range(2):
            torch.testing.assert_close(got[n] + res[n].sum(0), want[n],
                                       rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
