"""Port vs reference: Corollary 2 multilayer codes and partial-result
(multi-message) coding.

``repro_torch.core.{multilayer,partial}`` are copies of the reference's
modules with their imports renamed.  The cases of
``tests/test_multilayer_partial.py`` run in both packages from the same
seeds and numpy inputs; results must be equal (numpy, bit for bit), and
the decodes recover the sums within that file's bounds (1e-8).
"""
import numpy as np
import pytest

from repro.core import partial as ref_partial
from repro.core.hgc import HGCCode as RefCode
from repro.core.multilayer import MultiLayerCode as RefML
from repro.core.multilayer import TreeNode as RefTree
from repro.core.multilayer import min_load_fraction as ref_min_load
from repro.core.topology import Tolerance as RefTol
from repro.core.topology import Topology as RefTopo
from repro_torch.core import partial
from repro_torch.core.hgc import HGCCode
from repro_torch.core.multilayer import MultiLayerCode, TreeNode
from repro_torch.core.multilayer import min_load_fraction
from repro_torch.core.topology import Tolerance, Topology


@pytest.mark.parametrize("branching,s", [((2, 4, 8), (1, 1, 3)),
                                         ((3, 3), (1, 1)),
                                         ((2, 2, 2), (0, 0, 0))])
def test_min_load_fraction_equal(branching, s):
    assert min_load_fraction(branching, s) == ref_min_load(branching, s)


ML_CASES = [((2, 2, 2), (1, 1, 1), 8, 0), ((2, 2, 2), (0, 0, 0), 8, 0),
            ((3, 3), (1, 1), 9, 1), ((2, 3), (1, 2), 6, 4)]


@pytest.mark.parametrize("branching,s,K,seed", ML_CASES)
def test_multilayer_build_and_decode_equal(branching, s, K, seed):
    mine = MultiLayerCode.build(TreeNode.uniform(branching), s=s, K=K,
                                seed=seed)
    ref = RefML.build(RefTree.uniform(branching), s=s, K=K, seed=seed)
    assert mine.load == ref.load and mine.s == ref.s
    assert mine.leaf_parts == ref.leaf_parts
    np.testing.assert_array_equal(mine.leaf_coeffs, ref.leaf_coeffs)
    assert len(mine.codes) == len(ref.codes)
    for a, b in zip(mine.codes, ref.codes):
        np.testing.assert_array_equal(a.matrix, b.matrix)
        assert a.supports == b.supports
    g = np.random.default_rng(seed).normal(size=(K, 5))
    dead = [None, {0: {0}}] if s[0] > 0 else [None]
    for d in dead:
        got, want = mine.decode(g, d), ref.decode(g, d)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, g.sum(0), rtol=1e-8, atol=1e-8)


def test_two_level_multilayer_equals_hgc_load():
    ml = MultiLayerCode.build(TreeNode.uniform((3, 3)), s=(1, 1), K=9,
                              seed=1)
    hgc = HGCCode.build(Topology.uniform(3, 3), Tolerance(1, 1), K=9)
    assert ml.load == hgc.load == 4


@pytest.fixture(scope="module")
def codes():
    return (HGCCode.build(Topology.uniform(3, 3), Tolerance(1, 1), K=9,
                          seed=0),
            RefCode.build(RefTopo.uniform(3, 3), RefTol(1, 1), K=9, seed=0))


def test_prefix_messages_and_coeffs_equal(codes):
    mine, ref = codes
    g = np.random.default_rng(0).normal(size=(mine.K, 4))
    for i in range(mine.topo.n):
        np.testing.assert_array_equal(partial.prefix_coeff_matrix(mine, i),
                                      ref_partial.prefix_coeff_matrix(ref, i))
        for j in range(mine.topo.m[i]):
            np.testing.assert_array_equal(
                partial.worker_prefix_messages(mine, i, j, g),
                ref_partial.worker_prefix_messages(ref, i, j, g))


@pytest.mark.parametrize("lengths", [(4, 4, 0), (4, 0, 4), (2, 3, 2),
                                     (1, 0, 0), (0, 0, 0)])
def test_edge_decode_from_prefixes_equal(codes, lengths):
    mine, ref = codes
    g = np.random.default_rng(1).normal(size=(mine.K, 3))
    for i in range(mine.topo.n):
        msgs = {j: partial.worker_prefix_messages(mine, i, j, g)[:t]
                for j, t in enumerate(lengths) if t}
        got = partial.edge_decode_from_prefixes(mine, i, list(lengths),
                                                msgs)
        want = ref_partial.edge_decode_from_prefixes(ref, i, list(lengths),
                                                     msgs)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, mine.B.matrix[i] @ g,
                                       rtol=1e-7, atol=1e-8)
    if lengths[:2] == (4, 4):  # the fastest f_w workers' full results
        assert got is not None


@pytest.mark.parametrize("order", ["round_robin", "worker_by_worker"])
def test_earliest_decode_progress_equal(codes, order):
    mine, ref = codes
    D = mine.load
    if order == "round_robin":
        arrivals = [(j, t) for t in range(D) for j in range(3)]
    else:
        arrivals = [(j, t) for j in range(3) for t in range(D)]
    for i in range(mine.topo.n):
        got = partial.earliest_decode_progress(mine, i, arrivals)
        assert got == ref_partial.earliest_decode_progress(ref, i, arrivals)
        assert 0 < got <= 2 * D
