"""Port vs reference: the numpy HGC core, planners and cluster model.

``repro_torch.core`` is a copy of ``repro.core`` with its imports
renamed; these tests hold it to the reference on several topologies:
the encoding matrices, the collapsed decode weights λ, the part
assignments, the JNCSS plans and the sampled straggler patterns must be
identical (numpy, exact).
"""
import numpy as np
import pytest

from repro.api import CodedCluster as RefCluster
from repro.api import planner_for_scheme as ref_planner_for_scheme
from repro.api.cluster import sample_straggler_pattern as ref_sample
from repro.core import jncss as ref_jncss
from repro.core.hgc import HGCCode as RefCode
from repro.core.runtime_model import paper_cluster as ref_paper_cluster
from repro.core.topology import Tolerance as RefTol
from repro.core.topology import Topology as RefTopo
from repro.data.pipeline import TokenStream as RefStream
from repro_torch.api import CodedCluster, planner_for_scheme
from repro_torch.api.cluster import sample_straggler_pattern
from repro_torch.core import jncss
from repro_torch.core.hgc import HGCCode
from repro_torch.core.runtime_model import paper_cluster
from repro_torch.core.topology import Tolerance, Topology
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist.grad_sync import lam_array_from_code

CASES = [  # (m per edge, s_e, s_w, K)
    ((4, 4), 1, 1, 8),
    ((3, 3, 3), 1, 1, 0),
    ((2, 2, 2, 2), 2, 1, 0),
    ((4, 4), 0, 2, 0),
    ((3, 4, 5), 1, 1, 0),
]


def _codes(m, s_e, s_w, K, seed):
    kw = dict(K=K or None, seed=seed)
    kw = {k: v for k, v in kw.items() if v is not None}
    return (RefCode.build(RefTopo(m), RefTol(s_e, s_w), **kw),
            HGCCode.build(Topology(m), Tolerance(s_e, s_w), **kw))


@pytest.mark.parametrize("m,s_e,s_w,K", CASES)
def test_code_matrices_and_lambda_match(m, s_e, s_w, K):
    ref, mine = _codes(m, s_e, s_w, K, seed=3)
    assert mine.K == ref.K and mine.load == ref.load
    np.testing.assert_array_equal(mine.encoding_matrix_flat(),
                                  ref.encoding_matrix_flat())
    for i in range(len(m)):
        for j in range(m[i]):
            assert (mine.assignment.worker_parts(i, j)
                    == ref.assignment.worker_parts(i, j))
            np.testing.assert_array_equal(mine.worker_coeffs(i, j),
                                          ref.worker_coeffs(i, j))
    rng = np.random.default_rng(0)
    for _ in range(5):
        fast_e = tuple(sorted(rng.choice(len(m), len(m) - s_e,
                                         replace=False)))
        fast_w = [tuple(sorted(rng.choice(m[i], m[i] - s_w, replace=False)))
                  for i in range(len(m))]
        np.testing.assert_array_equal(
            mine.collapsed_weights(fast_e, fast_w),
            ref.collapsed_weights(fast_e, fast_w))


@pytest.mark.parametrize("dataset", ["mnist", "cifar"])
@pytest.mark.parametrize("K", [40, 120])
def test_jncss_plans_match(dataset, K):
    ref = ref_jncss.solve(ref_paper_cluster(dataset), K, with_grid=True)
    mine = jncss.solve(paper_cluster(dataset), K, with_grid=True)
    assert (mine.s_e, mine.s_w, mine.D) == (ref.s_e, ref.s_w, ref.D)
    assert (mine.e, mine.w) == (ref.e, ref.w)
    assert mine.T_tol == ref.T_tol
    np.testing.assert_array_equal(mine.grid, ref.grid)


@pytest.mark.parametrize("kind", ["homogeneous", "hetero"])
@pytest.mark.parametrize("scheme", ["hgc", "hgc_jncss", "uncoded"])
def test_planned_code_and_straggler_patterns_match(kind, scheme):
    ref_cl = getattr(RefCluster, kind)(2, 4)
    cl = getattr(CodedCluster, kind)(2, 4)
    ref_plan = ref_planner_for_scheme(scheme, 1, 1).plan(
        ref_cl.params, 8, seed=0)
    plan = planner_for_scheme(scheme, 1, 1).plan(cl.params, 8, seed=0)
    assert (plan.tol.s_e, plan.tol.s_w, plan.K) == (
        ref_plan.tol.s_e, ref_plan.tol.s_w, ref_plan.K)
    assert plan.expected_iteration_ms == ref_plan.expected_iteration_ms
    np.testing.assert_array_equal(plan.code.encoding_matrix_flat(),
                                  ref_plan.code.encoding_matrix_flat())
    for step in range(4):
        seq = np.random.SeedSequence([0, 7919, step])
        a = ref_sample(np.random.default_rng(seq), ref_plan.code,
                       ref_cl.params, ref_plan.code.load)
        b = sample_straggler_pattern(np.random.default_rng(seq), plan.code,
                                     cl.params, plan.code.load)
        assert a[0] == b[0] and list(a[1]) == list(b[1])
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(
            lam_array_from_code(plan.code, b[0], b[1], 2, 4),
            np.asarray(ref_plan.code.collapsed_weights(a[0], a[1]),
                       np.float32).reshape(2, 4))


def test_token_streams_draw_the_same_tokens():
    ref, mine = RefStream(256, 2, 16, seed=7), TokenStream(256, 2, 16,
                                                            seed=7)
    for _ in range(3):
        a, b = ref.next_batch(), mine.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert ref.state_dict() == mine.state_dict()
