"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

Every part is a file of its own under ``portbench/``, so a new
configuration, traffic mix, entry or per-layer metric is a new file and a
new entry in ``BENCHMARK.json``, never an edit:

=====================  =================================================
configuration          ``configs/<config>.json`` (its robot file beside)
traffic mix            ``traffic/<traffic>.json``
an entry's reference   ``reference/<entry>.py``
a per-layer reader     ``metrics/<metric>.py``, else, for a metric named
                       ``<prefix>_<family>``, ``metrics/<family>.py``
operation counts       ``counts/<config>.<entry>.json``
correctness limits     ``limits/<workload>.json``
peak rates             ``peaks.json``
=====================  =================================================
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DIR = "portbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    """Import a file of the benchmark by its path (it need not be part of
    an importable package)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    root: Path
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    def path(self, rel: str) -> Path:
        """A path that a configuration or mix gives relative to the
        checkout's root."""
        return self.root / rel


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / DIR / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / DIR / "traffic" / f"{name}.json")


def reference(entry: str, root: Path = ROOT):
    return _module(root / DIR / "reference" / f"{entry}.py",
                   f"portbench_reference_{entry}")


def reader(metric: str, root: Path = ROOT):
    base = root / DIR / "metrics"
    path = base / f"{metric}.py"
    if not path.is_file() and "_" in metric:
        path = base / f"{metric.rsplit('_', 1)[1]}.py"
    return _module(path, f"portbench_metric_{path.stem}")


def counts(config_name: str, entry: str, root: Path = ROOT) -> dict:
    return _json(root / DIR / "counts" / f"{config_name}.{entry}.json")


def limits(workload: str, root: Path = ROOT) -> dict:
    return _json(root / DIR / "limits" / f"{workload}.json")


def peaks(kind: str, root: Path = ROOT) -> dict:
    """The data-sheet peaks of the card whose name holds an entry's
    ``match``."""
    for card in _json(root / DIR / "peaks.json")["cards"]:
        if card["match"] in kind:
            return card
    raise KeyError(f"no peak rates for a {kind!r} in peaks.json")


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = matches[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    # every per-layer metric lists the cells that read it
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, root=root, chips=int(w["chips"]),
                config_name=w["config"], config=config(w["config"], root),
                traffic_name=w["traffic"], traffic=traffic(w["traffic"], root),
                end_to_end=e2e, per_layer=layer)
