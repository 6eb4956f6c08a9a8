"""What the benchmark runs never loads JAX or the JAX package, and the
plain reference never loads the program."""

import subprocess
import sys

from conftest import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "leansdr_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_program_paths_load_no_jax():
    """run.py, every driver with the program modules it calls, every
    metric reader and the control script, in one process."""
    code = """
import sys
sys.path.insert(0, '.')
from sdrbench import run, control, reference, stimulus, check, peaks
from sdrbench.harness import Cell, load_json
bench = load_json(run.REPO / 'BENCHMARK.json')
for w in bench['workloads']:
    cell = Cell(bench, w['name'])
    cell.driver_module()._program()
    cell.metric_readers()
"""
    loaded = _loaded(code)
    assert "leansdr_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_forbidden_names_compare_whole():
    from sdrbench.harness import forbidden_modules
    assert forbidden_modules(["leansdr_tpu_torch.pipelines", "numpy"]) == []
    assert forbidden_modules(["leansdr_tpu.dsp", "jax.numpy"]) == [
        "jax", "leansdr_tpu"]


def test_reference_loads_nothing_of_the_program():
    code = """
import sys
sys.path.insert(0, '.')
from sdrbench import reference, check, stimulus
"""
    loaded = _loaded(code)
    assert "leansdr_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
