"""Port vs reference: the nine comparison schemes of paper §V-A.

``repro_torch.core.schemes`` is a copy of ``repro.core.schemes`` with
its imports renamed plus each scheme's ``decode_weights`` and a tensor
route for ``gradient`` (one ``kernels.ops.combine``).  Every scheme is
built on the paper's 4 × 10 cluster at K = 40 and on
``CodedCluster.hetero(2, 4)`` at K = 8, in both packages from the same
seeds, and held to the reference:

  * ``load``, ``load_array`` and ``master_messages`` equal, the code
    matrices bit for bit;
  * ``iteration`` equal (time, fast edges, fast workers) over 50 samples
    from the same numpy generator;
  * ``gradient`` on a numpy ``g_parts`` (float64) within 1e-12·max of
    the reference's, and ``decode_weights(o) @ g_parts`` likewise;
  * ``gradient`` on a float32 CPU tensor (the combine's plain version)
    within 1e-5·max|reference|;
  * the exact schemes decode the plain sum Σ_k g_k: numpy within
    rtol = atol = 1e-7 (``tests/test_scheme_properties.py``'s bound for
    the reference), a float32 CPU tensor within 1e-5·max|Σ g|.
"""
import numpy as np
import pytest
import torch

from repro.api import CodedCluster as RefCluster
from repro.core import schemes as ref_schemes
from repro.core.runtime_model import paper_cluster as ref_paper_cluster
from repro_torch.api import CodedCluster
from repro_torch.core import schemes
from repro_torch.core.runtime_model import paper_cluster

CLUSTERS = {  # name → (reference params, port params, K)
    "paper": (lambda: ref_paper_cluster("mnist"),
              lambda: paper_cluster("mnist"), 40),
    "hetero24": (lambda: RefCluster.hetero(2, 4).params,
                 lambda: CodedCluster.hetero(2, 4).params, 8),
}
DIM = 37
N_SAMPLES = 50


def test_scheme_names_match():
    assert schemes.SCHEME_NAMES == ref_schemes.SCHEME_NAMES


_BUILT = {}


def _pair(name, cluster):
    """(reference scheme, port scheme, port params), built once."""
    key = (name, cluster)
    if key not in _BUILT:
        ref_fn, my_fn, K = CLUSTERS[cluster]
        ref_p, my_p = ref_fn(), my_fn()
        _BUILT[key] = (
            ref_schemes.make_scheme(name, ref_p.topo, K, params=ref_p,
                                    seed=0),
            schemes.make_scheme(name, my_p.topo, K, params=my_p, seed=0),
            my_p,
        )
    return _BUILT[key]


def _outcomes(name, cluster):
    """(reference, port) outcomes of the same 50 sampled iterations."""
    ref, mine, params = _pair(name, cluster)
    rng = np.random.default_rng(17)
    D = getattr(mine, "load_array", mine.load)
    out = []
    for _ in range(N_SAMPLES):
        sample = params.sample_iteration(rng, D)
        out.append((ref.iteration(sample), mine.iteration(sample)))
    return out


def _g_parts(K, seed=3):
    return np.random.default_rng(seed).standard_normal((K, DIM))


CASES = [(n, c) for c in CLUSTERS for n in schemes.SCHEME_NAMES]
IDS = [f"{n}-{c}" for n, c in CASES]


def _matrices(s):
    """Every code matrix a scheme carries (none for uncoded / greedy)."""
    if hasattr(s, "flat_code"):
        return [s.flat_code.matrix]
    if hasattr(s, "code"):
        code = s.code
        return ([code.B.matrix, code.encoding_matrix_flat()]
                + [d.matrix for d in code.Dbar])
    return []


@pytest.mark.parametrize("name,cluster", CASES, ids=IDS)
def test_loads_messages_and_codes_match(name, cluster):
    ref, mine, _ = _pair(name, cluster)
    assert mine.name == ref.name and mine.K == ref.K
    assert mine.exact == ref.exact
    assert mine.load == ref.load
    assert mine.master_messages == ref.master_messages
    assert hasattr(mine, "load_array") == hasattr(ref, "load_array")
    if hasattr(ref, "load_array"):
        np.testing.assert_array_equal(mine.load_array, ref.load_array)
    if hasattr(ref, "parts"):
        assert mine.parts == ref.parts
    mats, want = _matrices(mine), _matrices(ref)
    assert len(mats) == len(want)
    assert (len(mats) == 0) == (name in ("uncoded", "greedy"))
    for a, b in zip(mats, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,cluster", CASES, ids=IDS)
def test_iterations_match(name, cluster):
    for ref_o, my_o in _outcomes(name, cluster):
        assert my_o.time == ref_o.time
        assert my_o.fast_edges == ref_o.fast_edges
        assert my_o.fast_workers == ref_o.fast_workers


@pytest.mark.parametrize("name,cluster", CASES, ids=IDS)
def test_numpy_gradient_and_decode_weights_match(name, cluster):
    ref, mine, _ = _pair(name, cluster)
    g = _g_parts(mine.K)
    for ref_o, my_o in _outcomes(name, cluster)[::5]:
        want = ref.gradient(g, ref_o)
        tol = 1e-12 * max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(mine.gradient(g, my_o), want, rtol=0,
                                   atol=tol)
        a = mine.decode_weights(my_o)
        assert a.shape == (mine.K,) and a.dtype == np.float64
        np.testing.assert_allclose(a @ g, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name,cluster", CASES, ids=IDS)
def test_tensor_gradient_is_one_plain_combine(name, cluster):
    ref, mine, _ = _pair(name, cluster)
    g = _g_parts(mine.K).astype(np.float32)
    for ref_o, my_o in _outcomes(name, cluster)[::10]:
        want = ref.gradient(g.astype(np.float64), ref_o)
        got = mine.gradient(torch.from_numpy(g), my_o)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert got.shape == (DIM,)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


EXACT = [(n, c) for n, c in CASES if n != "greedy"]


@pytest.mark.parametrize("name,cluster", EXACT,
                         ids=[f"{n}-{c}" for n, c in EXACT])
def test_exact_schemes_decode_the_sum(name, cluster):
    _, mine, _ = _pair(name, cluster)
    assert mine.exact
    g = _g_parts(mine.K, seed=5)
    g32 = torch.from_numpy(g.astype(np.float32))
    true, true32 = g.sum(0), g32.sum(0)
    scale = true32.abs().max().item()
    for _, o in _outcomes(name, cluster):
        np.testing.assert_allclose(mine.gradient(g, o), true, rtol=1e-7,
                                   atol=1e-7)
        err = (mine.gradient(g32, o) - true32).abs().max().item()
        assert err <= 1e-5 * scale, (o, err, scale)


def test_greedy_weights_rescale_the_received_parts():
    _, mine, params = _pair("greedy", "paper")
    rng = np.random.default_rng(2)
    for _ in range(10):
        o = mine.iteration(params.sample_iteration(rng, mine.load))
        a = mine.decode_weights(o)
        got = np.flatnonzero(a)
        assert set(got) == set(mine._received(o))
        np.testing.assert_allclose(a[got], mine.K / len(got))
