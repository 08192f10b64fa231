"""A cell and the files it is made of, found by name.

- ``BENCHMARK.json`` at the root of the checkout: the manifest (units of
  the metrics, the cells and their configurations and traffic);
- ``portbench/workloads/<cell>.json``: the job, the model kind, the
  job's parameters, the per-layer metrics, the check's sizes and limits;
- ``portbench/configs/<config>.json``: the configuration (its ``family``,
  its ``model`` sizes and its compute ``dtype``);
- ``portbench/traffic/<traffic>.json``: the traffic mix;
- ``portbench/jobs/<job>.py``: the job's code;
- ``portbench/families/<family>.py``: the configuration's model family:
  the program's model built from the sizes, its weights' layout, its
  reference, its hand counts and its spans; the jobs reach the model only
  through it;
- ``portbench/metrics/<prefix>.py``: the reader of each per-layer metric
  whose name starts with ``<prefix>`` (up to the first dot).

Adding a cell, a mix, a metric reader or a model family is adding files
and manifest entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parent
MANIFEST = PACKAGE.parent / "BENCHMARK.json"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _json(MANIFEST)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(PACKAGE.parent)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_module(job: str, root: Path = PACKAGE) -> ModuleType:
    return _module(root / "jobs" / f"{job}.py", f"portbench_job_{job}")


def family_module(family: str, root: Path = PACKAGE) -> ModuleType:
    return _module(root / "families" / f"{family}.py",
                   f"portbench_family_{family}")


def reader(metric: str, root: Path = PACKAGE) -> ModuleType:
    prefix = metric.split(".")[0]
    return _module(root / "metrics" / f"{prefix}.py",
                   f"portbench_metric_{prefix}")


@dataclass
class Cell:
    name: str
    entry: Dict        # the manifest's entry of the cell
    workload: Dict     # portbench/workloads/<cell>.json
    config: Dict       # portbench/configs/<config>.json
    traffic: Dict      # portbench/traffic/<traffic>.json
    bench: Dict        # the manifest
    root: Path = PACKAGE  # where the cell's files were found

    @property
    def units(self) -> Dict[str, str]:
        return {m["name"]: m["unit"]
                for m in self.bench["end_to_end"] + self.bench["per_layer"]}

    @property
    def model(self) -> Dict:
        """The configuration's model sizes."""
        return self.config["model"]

    def family(self) -> ModuleType:
        """The configuration's model family (``families/<family>.py``)."""
        return family_module(self.config["family"], self.root)

    @property
    def end_to_end(self) -> List[str]:
        return self.metrics("end_to_end")

    @property
    def per_layer(self) -> List[str]:
        return self.metrics("per_layer")

    def metrics(self, kind: str) -> List[str]:
        """The manifest's metrics of ``kind`` that this cell reports: those
        that list it, and those that list no cells."""
        return [m["name"] for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load(name: str, bench: Dict = None, root: Path = PACKAGE) -> Cell:
    """Cell ``name`` of the manifest ``bench`` (``BENCHMARK.json``), its
    files found under ``root``."""
    bench = bench if bench is not None else manifest()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(entries)}")
    entry = entries[name]
    workload = _json(root / "workloads" / f"{name}.json")
    config = _json(root / "configs" / f"{entry['config']}.json")
    traffic = _json(root / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, workload, config, traffic, bench, root)
