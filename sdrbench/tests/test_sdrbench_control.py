"""The comparison that decides `correct`, shown to fail: on the CPU at a
small size, each cell's configuration run through its driver (the whole
run but the look for a chip) passes its limits; the control (the
reference at the precision below the configuration's, in the program's
place) does not; and neither does a run with the timed path broken
underneath by each fault the cell can have. Slow: ~2-4 minutes a run."""

import json
import shutil

import pytest
import torch

from sdrbench import control
from sdrbench.harness import Cell, load_json
from sdrbench.run import judge

from conftest import REPO

torch.set_num_threads(2)

SEED = 2 ** 33 + 17
# Each cell cut to a size the CPU's plain kernels run in a minute or two:
# the run's length and the number of carriers. The canonical stream's
# lock search is cut too (fastlock): without it leandvb tries its 4 sync
# hypotheses x 8 bit phases one after another, up to ~1M samples, ~20
# minutes of the CPU's plain demod. The windows are long enough for
# packets to fall due on a busy CPU: the plain demod takes seconds an
# input there, and the first `due_margin` + 1 inputs of a window hold no
# packet that is due.
FLEET_TINY = (dict(chunk_samples=8192, seg_warmup=256, seg_holdoff=1,
                   warmup_inputs=10),
              dict(demod_carriers=2, decoder_carriers=2, demod_chunk_lo=1,
                   demod_chunk_hi=2, demod_samples=2048,
                   start_samples=1024),
              dict(carriers=2, packets_per_loop=64, offset_center=1), 90.0)
TINY = {
    "fleet12seq-tp36": FLEET_TINY,
    # The segmented engine's fleet (not a cell of BENCHMARK.json while the
    # program loses packets there; see PERF.md) keeps its checks tested;
    # its CPU chunks cost under half the sequential demod's.
    "fleet12-tp36": ((dict(FLEET_TINY[0], segments=4),) + FLEET_TINY[1:3]
                     + (40.0,)),
    "canonical-u8": (dict(read_samples=8192, warmup_inputs=12,
                          fastlock=True),
                     dict(demod_read_lo=1, demod_read_hi=2,
                          demod_samples=1024, start_samples=1024),
                     dict(packets_per_loop=40), 60.0),
}
# Cells that are not in BENCHMARK.json: (configuration, traffic mix).
EXTRA = {"fleet12-tp36": ("dvbs-fleet-qpsk12", "tp36-12db")}


def _tiny_cell(tmp_path, workload):
    bench = load_json(REPO / "BENCHMARK.json")
    if workload in EXTRA:
        config, traffic = EXTRA[workload]
        bench["workloads"].append(dict(name=workload, config=config,
                                       traffic=traffic, chips=1, why="-"))
    root = tmp_path / "sdrbench"
    shutil.copytree(REPO / "sdrbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cell = Cell(bench, workload)
    cfg_up, check_up, traffic_up, seconds = TINY[workload]
    cfg = dict(cell.config, **cfg_up)
    if cfg.pop("fastlock", False):
        cfg["receiver"] = dict(cfg["receiver"], fastlock=True)
    cfg["check"] = dict(cfg["check"], **check_up)
    name = cell.workload["config"]
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    tr = dict(cell.traffic, **traffic_up)
    (root / "traffic" / f"{cell.workload['traffic']}.json").write_text(
        json.dumps(tr))
    return Cell(bench, workload, root=root), seconds


@pytest.mark.parametrize("workload", sorted(TINY))
def test_program_passes_and_control_fails(tmp_path, workload):
    cell, seconds = _tiny_cell(tmp_path, workload)
    prog, ctrl = control.reading(cell, SEED, seconds, "cpu",
                                 control=cell.config["control"])
    limits = cell.config["limits"]
    ok, judged = judge(prog, limits)
    assert ok, judged
    ok_c, judged_c = judge(ctrl, {k: v for k, v in limits.items()
                                  if k in ctrl})
    assert not ok_c, judged_c


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("fleet12seq-tp36", "fleet12-tp36")
    for f in ("state", "half", "ts", "dec", "sym")] + [
    ("canonical-u8", f) for f in ("state", "ts", "dec", "sym")])
def test_each_fault_fails(tmp_path, workload, fault):
    cell, seconds = _tiny_cell(tmp_path, workload)
    (row,) = control.reading(cell, SEED, seconds, "cpu", fault=fault)
    ok, judged = judge(row, cell.config["limits"])
    assert not ok, judged
