"""The port stands alone: leansdr_tpu_torch and chip_smoke.py import
neither jax nor leansdr_tpu, and the entry points default to CUDA and
raise without it (no quiet fallback to the CPU).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "leansdr_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m == 'leansdr_tpu' or m.startswith('leansdr_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "leansdr_tpu"}, roots


def test_entry_points_default_to_cuda():
    import torch
    from leansdr_tpu_torch.device import resolve_device
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=75, exact_lut=False, viterbi=True,
                   sampler="rrc")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiDvbsReceiver(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiDvbsReceiver(RxConfig(**(cfg.__dict__ | dict(rate="3/4"))), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_unported_settings_raise():
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
    base = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, float_scale=75,
                exact_lut=False, viterbi=True, sampler="rrc")
    for change, item in ((dict(constellation=Predef.PSK8), "item 20"),
                         (dict(viterbi=False), "item 7"),
                         (dict(exact_lut=True), "item 10"),
                         (dict(sampler="linear"), "item 10"),
                         (dict(cnr=True), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            MultiDvbsReceiver(RxConfig(**(base | change)), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        MultiDvbsReceiver(RxConfig(**base), 2, segments=8, device="cpu")
