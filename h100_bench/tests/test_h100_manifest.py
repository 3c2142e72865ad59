"""Every file the benchmark finds by name is there and parses, and the
manifest keeps to its contract's shape."""
from __future__ import annotations

import json
import re

import pytest

from h100_bench.bench.context import BENCH, ROOT, load
from h100_bench.bench.harness import (end_to_end_names, manifest, per_layer_names, reader,
                                      reader_path)

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_has_exactly_the_contract_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["paths"] == ["h100_bench"]
    assert MAN["command"][1].startswith("h100_bench/")
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_are_well_formed():
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in MAN["end_to_end"])
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        for cell in m["workloads"]:
            assert m["moves"] in end_to_end_names(MAN, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    wl = load("workloads", cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    cfg = load("configs", wl["config"])
    traffic = load("traffic", wl["traffic"])
    assert traffic["layout"] in ("inbox", "train")
    assert (BENCH / "entries" / f"{wl['entry']}.py").is_file()
    assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    assert wl["limits"] and all(isinstance(v, (int, float)) for v in wl["limits"].values())
    e2e = end_to_end_names(MAN, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    for name in per_layer_names(MAN, cell):
        assert callable(reader(name))
    assert per_layer_names(MAN, cell)


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_is_its_own_and_uncut(cfg):
    path = ROOT / cfg["file"]
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert cfg["reduced"] == data["reduced"] == []
    assert data["precision"].startswith("float32")
    assert sum(c["file"] == cfg["file"] for c in MAN["configs"]) == 1
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


def test_every_metric_file_is_named_in_the_manifest():
    named = {m["name"] for m in MAN["per_layer"]}
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    # each metric has a reader, and each reader reads some metric: its own,
    # or a family's (``device_idle_pct.py`` reads ``device_idle_pct.train``)
    used = {reader_path(n).stem for n in named}
    assert all(reader_path(n).is_file() for n in named)
    assert files == used


def test_a_family_shares_one_reader_and_a_metric_of_its_own_comes_first(tmp_path, monkeypatch):
    from h100_bench.bench import harness

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "idle.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "metrics" / "idle.serve.py").write_text("def read(run):\n    return 2\n")
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert reader_path("idle.train").name == "idle.py"
    assert reader("idle.train")({}) == 1 and reader("idle.serve")({}) == 2
    assert reader("idle")({}) == 1


def test_the_harness_reads_the_same_manifest():
    assert manifest() == MAN
