"""Port vs reference: the paper-evaluation simulator (§V).

``simulate_times`` must equal the reference's bit for bit for every
scheme.  ``simulate_training`` runs in both packages from the same
initial weights (the reference's seeded ones, carried over by
``classic_params_from_reference``) on the CPU: every scheme on the
logistic regression (paper_cluster("mnist"), K = 40, n_data 800,
batch_per_part 8, 5 iterations) and ``hgc`` on the CNN (K = 40,
batch_per_part 2, n_data 400, 2 iterations).  Gates: ``iter_times_ms``,
``eval_iters`` and ``eval_times_h`` equal; losses (the aggregate's norm)
within 1e-4·|loss|; accuracies within 2 / n_eval.  A run computes with
TF32 off and cuDNN deterministic, and leaves the caller's four backend
flags as it found them, also when it raises.
"""
import numpy as np
import pytest
import torch

from repro.core.runtime_model import paper_cluster as ref_paper_cluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.sim import simulator as ref_sim
from repro_torch.api import simulate_training
from repro_torch.checkpoint.params import classic_params_from_reference
from repro_torch.core.runtime_model import paper_cluster
from repro_torch.core.schemes import SCHEME_NAMES, make_scheme
from repro_torch.kernels import ops
from repro_torch.models import classic
from repro_torch.sim import simulator


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_simulate_times_bit_equal(name):
    for dataset in ("mnist", "cifar"):
        ref_p, my_p = ref_paper_cluster(dataset), paper_cluster(dataset)
        ref = ref_make_scheme(name, ref_p.topo, 40, params=ref_p, seed=0)
        mine = make_scheme(name, my_p.topo, 40, params=my_p, seed=0)
        np.testing.assert_array_equal(
            simulator.simulate_times(mine, my_p, 60, seed=3),
            ref_sim.simulate_times(ref, ref_p, 60, seed=3))


def _compare(name, dataset, **kw):
    seed = kw.get("seed", 0)
    ref_tr = ref_sim.simulate_training(name, ref_paper_cluster(dataset),
                                       dataset=dataset, **kw)
    init = classic_params_from_reference(
        ref_sim._make_model(dataset, seed)[0], "cpu")
    tr = simulate_training(name, paper_cluster(dataset), dataset=dataset,
                           device="cpu", init_params=init, **kw)
    assert tr.scheme == ref_tr.scheme == name
    np.testing.assert_array_equal(tr.iter_times_ms, ref_tr.iter_times_ms)
    np.testing.assert_array_equal(tr.eval_iters, ref_tr.eval_iters)
    np.testing.assert_array_equal(tr.eval_times_h, ref_tr.eval_times_h)
    assert np.isfinite(tr.losses).all()
    np.testing.assert_allclose(tr.losses, ref_tr.losses, rtol=1e-4, atol=0)
    assert tr.accuracies.shape == ref_tr.accuracies.shape
    assert np.abs(tr.accuracies - ref_tr.accuracies).max() \
        <= 2 / kw["n_eval"] + 1e-9
    assert tr.total_time_h == ref_tr.total_time_h
    return tr


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_logreg_training_matches_reference(name):
    _compare(name, "mnist", K=40, iters=5, batch_per_part=8, n_data=800,
             n_eval=200, eval_every=2, seed=0)


def test_cnn_training_matches_reference():
    _compare("hgc", "cifar", K=40, iters=2, batch_per_part=2, n_data=400,
             n_eval=64, eval_every=1, seed=0)


def test_one_combine_per_iteration(monkeypatch):
    """Every iteration's aggregate is one ``ops.combine`` call on the
    (K, dim) gradient matrix, whose rows are 16 bytes apart."""
    calls = []
    combine = ops.combine

    def spy(coeff, grads):
        calls.append((tuple(coeff.shape), tuple(grads.shape),
                      grads.stride()))
        return combine(coeff, grads)

    monkeypatch.setattr(ops, "combine", spy)
    for name in ("greedy", "standard_gc", "hgc_grouped"):
        calls.clear()
        run = simulator.TrainingRun(name, paper_cluster("mnist"), K=40,
                                    iters=3, batch_per_part=4, n_data=400,
                                    n_eval=50, device="cpu")
        for _ in range(3):
            run.step()
        dim = 784 * 10 + 10
        assert calls == [((1, 40), (40, dim), (dim + 2, 1))] * 3
        assert len(run.trace().losses) == 3
        with pytest.raises(RuntimeError, match="3 iterations"):
            run.step()


def test_init_params_are_copied_and_seeded_init_is_deterministic():
    kw = dict(K=40, iters=2, batch_per_part=4, n_data=400, n_eval=50,
              device="cpu")
    init = classic_params_from_reference(
        ref_sim._make_model("mnist", 0)[0], "cpu")
    before = {k: v.clone() for k, v in init.items()}
    simulate_training("uncoded", paper_cluster("mnist"), init_params=init,
                      **kw)
    for k, v in init.items():
        assert torch.equal(v, before[k])
    a = simulate_training("uncoded", paper_cluster("mnist"), **kw)
    b = simulate_training("uncoded", paper_cluster("mnist"), **kw)
    np.testing.assert_array_equal(a.losses, b.losses)


def test_simulate_training_refuses_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_training("hgc", paper_cluster("mnist"), iters=1)


#: the backend flags a run sets, and the values it computes under
_FLAGS = ((torch.backends.cudnn, "allow_tf32"),
          (torch.backends.cuda.matmul, "allow_tf32"),
          (torch.backends.cudnn, "deterministic"),
          (torch.backends.cudnn, "benchmark"))
_RUN_FLAGS = (False, False, True, False)


def _flags():
    return tuple(getattr(mod, name) for mod, name in _FLAGS)


@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("entry", ["simulate_training", "step"])
def test_run_computes_deterministically_and_restores_the_flags(
        monkeypatch, entry, raises):
    caller = tuple(not v for v in _RUN_FLAGS)
    for (mod, name), value in zip(_FLAGS, caller):
        monkeypatch.setattr(mod, name, value)
    seen = []
    part_grads = classic.part_grads

    def spy(*a, **kw):
        seen.append(_flags())
        if raises:
            raise FloatingPointError("a failing iteration")
        return part_grads(*a, **kw)

    monkeypatch.setattr(simulator.classic, "part_grads", spy)
    kw = dict(dataset="cifar", K=40, iters=2, batch_per_part=1, n_data=200,
              n_eval=8, device="cpu")
    if entry == "simulate_training":
        def run():
            simulate_training("hgc", paper_cluster("cifar"), **kw)
    else:
        training = simulator.TrainingRun("hgc", paper_cluster("cifar"),
                                         **kw)
        assert _flags() == caller

        def run():
            training.step()
            training.step()
    if raises:
        with pytest.raises(FloatingPointError, match="failing iteration"):
            run()
    else:
        run()
    assert seen == [_RUN_FLAGS] * (1 if raises else 2)
    assert _flags() == caller
