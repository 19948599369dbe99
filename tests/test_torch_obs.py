"""The port's spans and counters (``repro_torch.obs``) on the CPU.

Off (no profiler recording): no tally, no profiler range, the very
tensors out of ``enter`` and ``exit``, and the launch counts with the
kernel names alone.  On (``torch.profiler`` with CPU activity) over
tiny dense and MoE coded steps: each span's count, its parent, and the
same count of profiler ranges; the losses bit for bit as with tracing
off; ``moe.dropped`` against a direct count of the dispatch plan.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import moe
from torch_reference import few_threads  # noqa: F401 (autouse)

PODS, WORKERS, STEPS = 2, 2, 2
ARCHS = {"dense": "llama3-8b", "moe": "granite-moe-3b-a800m"}


@pytest.fixture(autouse=True)
def clean_tally():
    obs.reset()
    yield
    obs.reset()


def _session(arch: str) -> CodedSession:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return CodedSession(
        CodedCluster.homogeneous(PODS, WORKERS), cfg,
        planner=planner_for_scheme("hgc", 1, 1), mode="coded_q",
        grad_compression="int8", seq_len=16, optimizer="adamw", lr=1e-3,
        total_steps=4, seed=0, verbose=False, device="cpu")


def _traced_steps(arch: str):
    """(session, snapshot, parents, profiler events) of STEPS profiled
    coded steps."""
    s = _session(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.fit(STEPS)
        snap, parents = obs.snapshot(), obs.parents()
    return s, snap, parents, prof.events()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def traced(request):
    obs.reset()
    s, snap, parents, events = _traced_steps(ARCHS[request.param])
    obs.reset()
    return request.param, s, snap, parents, events


def test_off_records_nothing_and_keeps_the_tensors(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not obs.recording()
    assert obs.span("a") is obs.span("b")
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(2, requires_grad=True)
    with obs.span("a"):
        pass
    with obs.span("moe.route", grad=True) as (enter, exit):
        assert enter(x) is x
        a, b = exit(x, y)
        assert a is x and b is y
    obs.count("moe.routed", 5)
    s = _session(ARCHS["moe"])
    s.fit(1)
    assert opened == []
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert obs.parents() == {}


def test_on_grad_span_without_grad_keeps_the_tensors():
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode(), obs.span("r", grad=True) as (en, ex):
            t = torch.ones(2)
            assert en(t) is t and ex(t) is t
        with torch.no_grad(), obs.span("r", grad=True) as (en, ex):
            assert en(x) is x and ex(x) is x
        with obs.span("r", grad=True) as (en, ex):
            t = torch.ones(2)  # requires no grad: nothing to bracket
            assert en(t) is t and ex(t) is t
    assert obs.snapshot()["span.r.n"] == 3
    assert "span.r.bwd.n" not in obs.snapshot()


def test_counts_of_the_coded_step(traced):
    kind, s, snap, _, _ = traced
    groups = PODS * WORKERS
    assert snap["span.coded.batch.n"] == STEPS
    assert snap["span.model.forward.n"] == groups * STEPS
    assert snap["span.model.backward.n"] == groups * STEPS
    assert snap["span.coded.edge_decode.n"] == groups * STEPS
    assert snap["span.coded.hop.n"] == (PODS + 1) * STEPS
    assert snap["span.coded.update.n"] == STEPS
    layers = s.cfg.n_layers
    assert snap["span.model.remat.n"] == layers * groups * STEPS
    moe_spans = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
    for name in moe_spans:
        want = layers * groups * STEPS if kind == "moe" else None
        assert snap.get(f"span.{name}.n") == want
        assert snap.get(f"span.{name}.bwd.n") == want
    assert not any(k.endswith(".device_ms") for k in snap)  # no card here
    assert {k for k in snap if "." not in k} == set(ops.KERNELS)


def test_children_within_their_parents(traced):
    _, _, snap, parents, _ = traced
    assert parents["model.remat"] == "model.backward"
    assert parents["model.forward"] is None
    for name, parent in parents.items():
        if parent is not None:
            assert snap[f"span.{name}.host_ms"] <= \
                snap[f"span.{parent}.host_ms"], (name, parent)
    if "moe.route" in parents:
        assert parents["moe.route"] == "model.forward"
        assert parents["moe.route.bwd"] == "model.backward"


def test_profiler_ranges_match_the_tally(traced):
    """Every tallied span lies on the profiler's timeline as often as it
    is counted; the recompute's own ranges (inside ``model.remat``) are
    the recomputed forward's, not tallied again."""
    _, _, snap, parents, events = traced
    remat = [e.time_range for e in events if e.name == obs.REMAT]

    def in_remat(e):
        return any(r.start <= e.time_range.start and e.time_range.end <=
                   r.end for r in remat) and e.name != obs.REMAT

    seen = {}
    for e in events:
        if e.name in parents and not in_remat(e):
            seen[e.name] = seen.get(e.name, 0) + 1
    assert seen == {name: snap[f"span.{name}.n"] for name in parents}


def test_reset_clears():
    obs.launched("flash_attention")
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("a"):
            obs.count("c", torch.tensor(3))
            obs.count("c", 2)
    snap = obs.snapshot()
    assert snap["flash_attention"] == 1 and snap["count.c"] == 5
    assert snap["span.a.n"] == 1
    obs.reset()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert obs.parents() == {}


def test_count_computes_only_what_it_keeps():
    calls = []

    def v():
        calls.append(1)
        return torch.tensor(4)

    obs.count("c", v)  # no profiler: not called
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.recompute():
            obs.count("c", v)  # a recomputation: not called
        obs.count("c", v)
    assert len(calls) == 1
    assert obs.snapshot()["count.c"] == 4


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_losses_bit_for_bit_with_tracing_on(kind):
    off = _session(ARCHS[kind])
    off.fit(STEPS)
    on = _session(ARCHS[kind])
    with profile(activities=[ProfilerActivity.CPU]):
        on.fit(STEPS)
    assert on.losses == off.losses
    for a, b in zip(on.aux_losses, off.aux_losses):
        assert a == b


@pytest.mark.parametrize("skewed", [True, False])
def test_dropped_counts_the_sentinel_entries(skewed):
    """``moe.dropped`` equals the dispatch plan's entries sent to the
    sentinel slot: many under a router that sends every token to expert
    0, none where the capacity holds every choice."""
    gen = torch.Generator().manual_seed(1)
    d, ff, E, k = 16, 8, 4, 2
    params = moe.init_moe(d, ff, E, 0, gen)
    x = torch.randn(2, 12, d, generator=gen)
    cf = 1.25
    if skewed:
        params["router"] = torch.zeros(d, E)
        params["router"][:, 0] = 1.0
        x = x.abs()
    else:
        cf = float(E)  # every expert holds all N · k entries
    N = x.shape[0] * x.shape[1]
    _, _, top_e = moe.route(params["router"], x.reshape(N, d), k)
    cap = moe.capacity(N, k, E, cf)
    _, slot, _ = moe.dispatch_slots(top_e, E, cap)
    want = int((slot == E * cap).sum())
    assert (want > 0) == skewed
    with profile(activities=[ProfilerActivity.CPU]):
        moe.moe_ffn(params, x, k, capacity_factor=cf)
        snap = obs.snapshot()
    assert snap["count.moe.dropped"] == want
    assert snap["count.moe.routed"] == N * k


def test_moe_layer_output_and_grads_unchanged_by_spans():
    gen = torch.Generator().manual_seed(2)
    params = moe.init_moe(16, 8, 4, 0, gen)
    for p in params.values():
        p.requires_grad_(True)
    x = torch.randn(2, 10, 16, generator=gen, requires_grad=True)

    def run():
        y, aux = moe.moe_ffn(params, x, 2)
        grads = torch.autograd.grad((y.square().sum() + aux),
                                    [x] + list(params.values()))
        return [y.detach()] + list(grads)

    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
        snap = obs.snapshot()
    assert snap["span.moe.combine.bwd.n"] == 1
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert np.isfinite([float(t.abs().max()) for t in on]).all()
