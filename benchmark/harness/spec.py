"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix:
``configs/<config>.json`` (its ``family`` picks ``harness/families/
<family>.py``), ``traffic/<traffic>.json`` (its ``kind`` picks
``harness/loads/<kind>.py``) and ``limits/<cell>.json`` (the numbers
``correct`` compares). A per-layer metric is read by
``metrics/<metric name>.py``'s ``read(run)``. A new model, mix or metric is
new files and new entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module (metric files carry dots in
    their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list

    def family(self):
        return importlib.import_module(
            f"benchmark.harness.families.{self.config['family']}")

    def load(self):
        return importlib.import_module(
            f"benchmark.harness.loads.{self.traffic['kind']}")

    def reader(self, metric: dict):
        return load_module(BENCH / "metrics" / f"{metric['name']}.py",
                           f"benchmark_metric_{metric['name']}")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, manifest: dict | None = None,
              bench: Path = BENCH) -> Cell:
    manifest = manifest or load_json(bench.parent / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, entry=entry,
        config=load_json(bench.parent / config["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"]
                   if _reports(m, name, names)])
