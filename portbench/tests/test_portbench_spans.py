"""The readers of the program's spans and counters: silent on records
without their keys, and the expected value on a hand-built tally."""
from __future__ import annotations

import pytest

from portbench import spec
from portbench.tests.portbench_tiny import ROOT
from portbench.tests.test_portbench_result import fake_records

STEPS, LENGTH, BATCH = 2, 1500, 96

#: what ``repro_torch.obs.snapshot()`` holds after two profiled steps
#: (or one profiled batch), with each metric's value from it
LAUNCHES = {
    "flash_attention": 64, "coded_combine_q": 24,
    "span.coded.batch.n": 2, "span.coded.batch.host_ms": 80.0,
    "span.coded.batch.device_ms": 84.0,
    "span.model.forward.n": 16, "span.model.forward.device_ms": 500.0,
    "span.model.backward.n": 16, "span.model.backward.device_ms": 1300.0,
    "span.coded.edge_decode.n": 16, "span.coded.edge_decode.device_ms": 90.0,
    "span.coded.hop.n": 6, "span.coded.hop.device_ms": 60.0,
    "span.coded.update.n": 2, "span.coded.update.device_ms": 40.0,
    "span.moe.route.n": 256, "span.moe.route.device_ms": 30.0,
    "span.moe.route.bwd.n": 256, "span.moe.route.bwd.device_ms": 10.0,
    "span.moe.dispatch.device_ms": 100.0,
    "span.moe.dispatch.bwd.device_ms": 300.0,
    "span.moe.combine.device_ms": 120.0,
    "span.moe.combine.bwd.device_ms": 480.0,
    "span.moe.experts.device_ms": 200.0,
    "span.moe.experts.bwd.device_ms": 400.0,
    "count.moe.routed": 4000, "count.moe.dropped": 50,
    "span.serving.prefill.n": 1, "span.serving.prefill.device_ms": 4896.0,
    "span.serving.handoff.n": 1, "span.serving.handoff.device_ms": 61.0,
    "span.serving.decode.n": 13, "span.serving.decode.device_ms": 325.0,
}
WANT = {
    "train_batch_ms": 42.0, "train_forward_ms": 250.0,
    "train_backward_ms": 650.0, "train_edge_decode_ms": 45.0,
    "train_hop_ms": 30.0, "train_update_ms": 20.0,
    "moe_route_ms": 20.0, "moe_shuffle_ms": 500.0, "moe_experts_ms": 300.0,
    "moe_dropped_pct": 1.25, "serve_prefill_span_ms_per_ktok": 34.0,
    "serve_handoff_ms": 61.0, "serve_decode_span_ms": 25.0,
}
CELL = {"train": "granite8b.train_s512", "moe": "granitemoe.train_s1024",
        "serve": "granite8b.serve_code"}


def _cell_of(name: str) -> str:
    if name.startswith("moe_"):
        return CELL["moe"]
    return CELL["serve" if name.startswith("serve_") else "train"]


def _records(name: str, trace) -> dict:
    rec = fake_records(spec.load(ROOT, _cell_of(name)))
    rec["traffic"] = dict(rec["traffic"], batch=BATCH)
    if trace is not None:
        rec["trace"] = dict(trace, steps=1 if name.startswith("serve_")
                            else STEPS, length=LENGTH)
    return rec


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_silent_without_its_keys(name):
    read = spec.reader(name)
    assert read(fake_records(spec.load(ROOT, _cell_of(name)))) is None
    assert read(_records(name, None)) is None
    bare = {"device": [("k", 0.0, 1.0)], "host": [], "host_device": [],
            "window_s": 0.002, "launches": {"flash_attention": 4}}
    assert read(_records(name, bare)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value_of_a_hand_built_tally(name):
    trace = {"device": [], "host": [], "host_device": [], "window_s": 2.0,
             "launches": LAUNCHES}
    assert spec.reader(name)(_records(name, trace)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_is_declared_for_its_cells(name):
    """Each new metric names its cells and the end-to-end metric it
    moves, and each of its cells loads it."""
    from portbench.tests.portbench_tiny import bench

    entry = {m["name"]: m for m in bench()["per_layer"]}[name]
    assert entry["source"] == "device_trace"
    assert _cell_of(name) in entry["workloads"]
    for cell in entry["workloads"]:
        c = spec.load(ROOT, cell)
        assert name in {m["name"] for m in c.per_layer}
        assert entry["moves"] in {m["name"] for m in c.end_to_end}
