"""The harness finds every cell's files by name, and a new metric, mix
or configuration is found as a new file with no edit."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import spec
from portbench.tests.portbench_tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = spec.load(ROOT, cell)
    assert c.model["n_layers"] > 0
    assert spec.driver(c).run
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_benchmark_json_follows_the_naming_rules():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", ())) <= cells
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def test_new_metric_mix_and_config_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by added files and entries alone."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    (base / "configs" / "granite-8b-stage2.json").write_text(json.dumps(
        dict(json.loads((base / "configs" / "granite-8b-stage6.json")
                        .read_text()), name="granite-8b-stage2")))
    (base / "traffic" / "train_s256.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "train_s512.json").read_text()),
             seq_len=256)))
    (base / "limits" / "granite8b.train_s256.json").write_text(
        (base / "limits" / "granite8b.train_s512.json").read_text())
    (base / "metrics" / "steps_done.py").write_text(
        "def read(rec):\n    return float(rec.get('steps', 0)) or None\n")
    b["configs"].append(dict(b["configs"][0], name="granite-8b-stage2",
                             file="portbench/configs/granite-8b-stage2.json"))
    b["workloads"].append({"name": "granite8b.train_s256",
                           "config": "granite-8b-stage2",
                           "traffic": "train_s256", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("granite8b.train_s256")
    b["per_layer"].append({"name": "steps_done", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.load(tmp_path, "granite8b.train_s256", base)
    assert c.traffic["seq_len"] == 256
    assert c.config["name"] == "granite-8b-stage2"
    assert "steps_done" in {m["name"] for m in c.per_layer}
    assert spec.reader("steps_done", base)({"steps": 3}) == 3.0
    assert spec.reader("steps_done", base)({}) is None
    assert spec.driver(c, base).run
