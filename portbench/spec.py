"""What a run is, found by name in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of
its own (``configs/<file>``, ``traffic/<mix>.json``), the traffic's
``kind`` names its driver (``drivers/<kind>.py``), each metric is read
by ``metrics/<name>.py`` and a cell's correctness limits are in
``limits/<cell>.json``.  Adding any of them is adding files and
entries: nothing here lists them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict      # the configuration's file
    traffic: Dict     # the traffic mix's file
    limits: Dict      # name → limit of each number compared
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def model(self) -> Dict:
        """The configuration as the program runs it."""
        return self.config["model"]


def model_config(m: Dict):
    """The program's ``ModelConfig`` of a configuration's ``model`` block."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in m.items()})


def load_module(path: Path, name: str) -> ModuleType:
    """Import ``path`` (whose name may hold dots) as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load(root: Path, workload: str, base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its traffic and
    limits found under ``base``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def driver(cell: Cell, base: Path = HERE) -> ModuleType:
    """The driver of the cell's traffic kind."""
    kind = cell.traffic["kind"]
    return load_module(base / "drivers" / f"{kind}.py",
                       f"portbench_driver_{kind}")


def reader(name: str, base: Path = HERE):
    """``read(records) → value or None`` of metric ``name``."""
    return load_module(base / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_")).read
