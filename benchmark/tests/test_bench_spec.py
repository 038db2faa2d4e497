"""BENCHMARK.json and the files it names: every piece found by name, and a
cell added by adding files and entries alone."""

import json
import os
import re
import shutil

import pytest

from benchmark.lib import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_pieces(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        driver = cell.driver()
        for fn in ("setup", "call", "slice_call", "check"):
            assert callable(getattr(driver, fn))
        assert cell.config["name"] == w["config"]
        assert set(cell.mix["limits"]) == {"missed", "extra", "support_off"}
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))


def test_a_split_quantity_has_one_reader():
    """``discover.score_ms.wgs`` and ``.panel`` read one file; a name with
    no file of its own or of its stem has no reader."""
    assert spec.reader("discover.score_ms.wgs").__code__ is not spec.reader("discover.score_ms.panel").__code__
    assert spec.reader("discover.score_ms.wgs").__code__.co_filename == spec.reader("discover.score_ms.panel").__code__.co_filename
    assert spec.reader("discover.front_end_ms.panel").__code__.co_filename.endswith("discover.front_end_ms.panel.py")
    with pytest.raises(FileNotFoundError):
        spec.reader("discover.no_such_ms.wgs")


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]} and m["layer"] in layers
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_a_cell_is_added_by_files_alone(tmp_path, bench):
    """A new configuration file, a new mix file and new entries make a new
    cell; no file that is there changes."""
    os.makedirs(tmp_path / "benchmark" / "configs")
    shutil.copytree(os.path.join(ROOT, "benchmark", "mixes"), tmp_path / "benchmark" / "mixes")
    new = json.loads(json.dumps(bench))
    with open(os.path.join(ROOT, "benchmark", "configs", "hg002_35x.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "hg002_35x_deep"
    cfg["library"]["depth"] = 60
    with open(tmp_path / "benchmark" / "configs" / "hg002_35x_deep.json", "w") as f:
        json.dump(cfg, f)
    mix = {"entry": "discover_regions", "regions": {"count": 10, "min_bases": 1000, "max_bases": 2000},
           "edge_bases": 152, "warm_up_calls": 1, "limits": {"missed": 0, "extra": 0, "support_off": 0}}
    with open(tmp_path / "benchmark" / "mixes" / "short_regions.json", "w") as f:
        json.dump(mix, f)
    new["configs"].append({"name": "hg002_35x_deep", "source": "x", "file": "benchmark/configs/hg002_35x_deep.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "hg002_35x_deep.short_regions", "config": "hg002_35x_deep",
                             "traffic": "short_regions", "chips": 1, "why": "x"})
    new["end_to_end"][1]["workloads"].append("hg002_35x_deep.short_regions")
    cell = spec.Cell(new, "hg002_35x_deep.short_regions", root=str(tmp_path))
    assert cell.config["library"]["depth"] == 60 and cell.mix["regions"]["count"] == 10
    assert cell.driver().__name__ == "benchmark.drivers.discover_regions"
    assert {m["name"] for m in cell.end_to_end} == {"region_call_p95_ms", "setup_s"}
    with pytest.raises(KeyError):
        spec.Cell(bench, "hg002_35x_deep.short_regions")


def test_without_a_card_a_run_fails_and_prints_no_result(cuda_absent):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", "hg002_35x.panel_call",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
