"""The result line's keys, and a run that finds no card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import check, run, spec
from portbench.tests.portbench_tiny import ROOT

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def fake_records(cell):
    return {"setup_s": 12.5, "window_s": 10.0, "steps": 4, "tokens": 16384,
            "flops": 4e14, "model": cell.model, "traffic": cell.traffic,
            "computed_rows": 32, "leaf_sizes": {"a": 64}}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(trace, capsys):
    cell = spec.load(ROOT, "granite8b.train_s512")
    rec = fake_records(cell)
    if trace:
        rec["trace"] = {"device": [("k", 0.0, 900.0), ("k", 950.0, 1000.0)],
                        "host": [("aten::mm", 0.0, 2000.0)],
                        "host_device": [("k", 0.0, 1000.0)],
                        "window_s": 0.002, "launches": {}, "steps": 1}
    checks = check.training(
        {"losses": [1.0], "grad_norms": {"a": 1.0}, "change": {"a": 1.0}},
        {"losses": [1.0], "grad_norms": {"a": 1.0}, "change": {"a": 1.0}},
        cell.limits)
    out = {"records": rec, "checks": checks, "attempted": 4, "failed": 0,
           "memory_peak_bytes": 123}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1}
    assert run.report(cell, bool(trace), out, device) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert CONTRACT <= set(line)
    assert set(line) - CONTRACT <= {"breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] == pytest.approx(0.00095)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert line["metrics"]["train_tokens_per_s"]["value"] == 1638.4
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    lines = captured.err.strip().splitlines()
    assert [x.split(":")[0] for x in lines[-3:]] == \
        ["check loss_gap", "check grad_gap", "check change_gap"]


def test_no_card_exits_nonzero_with_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite8b.train_s512", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(ROOT / "build")})
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", object())
    assert run.loaded_forbidden() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert run.loaded_forbidden() == []


@pytest.mark.parametrize("name", ["granite8b.train_s512",
                                  "granite8b.serve_code"])
def test_traced_run_reports_only_what_it_read(name, capsys):
    """The traced path end to end on the CPU: the profiler sees no device
    work there, so every device metric stays silent (none reads 0) and
    the host-clock ones are reported."""
    import time

    import torch

    from portbench.tests import portbench_tiny as tiny

    c = tiny.cell(name)
    out = spec.driver(c).run(c, 5, 0.2, True, torch.device("cpu"),
                             lambda: None, time.time())
    assert out["records"]["trace"]["device"] == []
    assert run.report(c, True, out, {"platform": "cpu", "kind": "cpu",
                                     "count": 1}) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    host = {m["name"] for m in c.per_layer if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host
