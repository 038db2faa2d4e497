"""Finds a cell's pieces by name: its entry in BENCHMARK.json, its
configuration, its traffic mix, its driver and its per-layer readers.
Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _load_json(os.path.join(root, self.config_entry["file"]))
        self.mix = _load_json(os.path.join(root, "benchmark", "mixes", self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name, self.end_to_end)]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.mix['entry']}")


def _reports(metric: dict, cell: str, end_to_end: list) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in {m["name"] for m in end_to_end}


def reader(metric_name: str):
    """The ``read(ctx)`` of ``layer_metrics/<metric_name>.py`` or, where
    there is none, of the file named without the last dotted part (a
    quantity split by the cells' end-to-end metrics, ``discover.score_ms.wgs``
    and ``.panel``, has one reader)."""
    path = os.path.join(HERE, "layer_metrics", metric_name + ".py")
    if not os.path.isfile(path) and "." in metric_name:
        path = os.path.join(HERE, "layer_metrics", metric_name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("layer_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
