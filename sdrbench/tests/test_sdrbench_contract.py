"""BENCHMARK.json against the benchmark contract's rules of form, and the
harness's lookup of configurations, traffic mixes and metrics by name."""

import json
import re
import shutil

import pytest

from sdrbench.harness import Cell, load_json

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = load_json(REPO / "BENCHMARK.json")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_entries_have_the_contracts_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (REPO / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"]
                                              for w in BENCH["workloads"]}


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = Cell(BENCH, w["name"])
        assert cell.driver_module().Driver
        assert len(cell.metric_readers()) == len(cell.per_layer) > 0
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with a cell naming them, run through the harness's lookup
    without an edit to any file that was there."""
    root = tmp_path / "sdrbench"
    shutil.copytree(REPO / "sdrbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = load_json(root / "configs" / "dvbs-fleet-qpsk12.json")
    cfg["segments"] = 4
    (root / "configs" / "fleet-s4.json").write_text(json.dumps(cfg))
    tr = load_json(root / "traffic" / "tp36-12db.json")
    tr.update(carriers=128, pace="realtime")
    (root / "traffic" / "c128-live.json").write_text(json.dumps(tr))
    (root / "metrics" / "fleet.chunks.py").write_text(
        "def read(data):\n    return float(len(data['latency_ms']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="fleet-s4", source="s", why="w",
                                 file="sdrbench/configs/fleet-s4.json",
                                 reduced=[]))
    bench["workloads"].append(dict(name="fleet-s4.live", config="fleet-s4",
                                   traffic="c128-live", chips=1, why="w"))
    bench["per_layer"].append(dict(name="fleet.chunks", unit="1",
                                   better="higher", source="host_clock",
                                   layer="service", moves="fleet.realtime_x",
                                   workloads=["fleet-s4.live"]))
    cell = Cell(bench, "fleet-s4.live", root=root)
    assert cell.config["segments"] == 4 and cell.traffic["carriers"] == 128
    assert cell.driver_module().Driver
    readers = cell.metric_readers()
    assert readers["fleet.chunks"].read({"latency_ms": [1, 2]}) == 2.0
    assert {p: p.read_bytes() for p in before} == before
