"""The segmented fleet's cell (fleet12-tp36 on dvbs-fleet-qpsk12-s8,
drivers/fleet_seg.py, reference_seg.py) cut to the CPU's size as
test_sdrbench_control.py cuts its cells: the program passes its limits
and prints its difference from the former reference and its handover
counters, the control does not pass, nor a run with any of the faults
the fleet's driver plants. Slow: ~2-4 minutes a run."""

import json
import shutil

import pytest

from sdrbench import control
from sdrbench.harness import Cell, load_json
from sdrbench.run import judge

from conftest import REPO
from test_sdrbench_control import SEED, TINY

CELL = "fleet12-tp36"


def _tiny(tmp_path):
    bench = load_json(REPO / "BENCHMARK.json")
    root = tmp_path / "sdrbench"
    shutil.copytree(REPO / "sdrbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cell = Cell(bench, CELL)
    assert cell.config["driver"] == "fleet_seg"
    cfg_up, check_up, traffic_up, seconds = TINY[CELL]
    cfg = dict(cell.config, **cfg_up)
    cfg["check"] = dict(cfg["check"], **check_up)
    (root / "configs" / f"{cell.workload['config']}.json").write_text(
        json.dumps(cfg))
    (root / "traffic" / f"{cell.workload['traffic']}.json").write_text(
        json.dumps(dict(cell.traffic, **traffic_up)))
    return Cell(bench, CELL, root=root), seconds


def test_program_passes_and_control_fails(tmp_path):
    cell, seconds = _tiny(tmp_path)
    prog, ctrl = control.reading(cell, SEED, seconds, "cpu",
                                 control=cell.config["control"])
    limits = cell.config["limits"]
    ok, judged = judge(prog, limits)
    assert ok, judged
    assert 0 <= prog["demod_diff_first_anchor"] <= 1
    assert prog["seg_boundaries"] > 0
    assert 0 <= prog["seg_realigned"] <= prog["seg_boundaries"]
    ok_c, judged_c = judge(ctrl, {k: v for k, v in limits.items()
                                  if k in ctrl})
    assert not ok_c, judged_c


@pytest.mark.parametrize("fault", ["state", "half", "ts", "dec", "sym"])
def test_fault_fails(tmp_path, fault):
    cell, seconds = _tiny(tmp_path)
    (row,) = control.reading(cell, SEED, seconds, "cpu", fault=fault)
    ok, judged = judge(row, cell.config["limits"])
    assert not ok, judged
