"""The port stands alone: leansdr_tpu_torch and chip_smoke.py import
neither jax nor leansdr_tpu, and the entry points default to CUDA and
raise without it (no quiet fallback to the CPU).
"""

import ast
import os
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
    assert {"leansdr_tpu_torch.dsp.fft_kernel",
            "leansdr_tpu_torch.dsp.acquisition",
            "leansdr_tpu_torch.fec.deconv_device",
            "leansdr_tpu_torch.apps.leandvbfleet",
            "leansdr_tpu_torch.pipelines.multi_rx",
            "leansdr_tpu_torch.pipelines.chansim",
            "leansdr_tpu_torch.pipelines.dvbs_tx",
            "leansdr_tpu_torch.proto.hdlc",
            "leansdr_tpu_torch.util.ad936x",
            "leansdr_tpu_torch.util.pmp",
            "leansdr_tpu_torch.apps.leantsgen",
            "leansdr_tpu_torch.apps.leandvbtx",
            "leansdr_tpu_torch.apps.leanchansim",
            "leansdr_tpu_torch.apps.leansdrcat",
            "leansdr_tpu_torch.apps.leansdrserv",
            "leansdr_tpu_torch.apps.leandvb_tui",
            "leansdr_tpu_torch.apps.leaniio",
            "leansdr_tpu_torch.pipelines.dvbs_tx_device",
            "leansdr_tpu_torch.pipelines.scan_rx",
            "leansdr_tpu_torch.pipelines.mlm_rx",
            "leansdr_tpu_torch.apps.leansdrscan",
            "leansdr_tpu_torch.apps.leanmlmrx",
            "leansdr_tpu_torch.dsp.fft",
            "leansdr_tpu_torch.parallel",
            "leansdr_tpu_torch.parallel.group",
            "leansdr_tpu_torch.parallel.halo",
            "leansdr_tpu_torch.parallel.mesh",
            "leansdr_tpu_torch.parallel.timeshard",
            "leansdr_tpu_torch.parallel.multihost",
            "leansdr_tpu_torch.util.ingest"} <= set(_modules())
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


def test_slice10_names_and_cuda_defaults():
    """Slice 10's modules carry the JAX package's public names (the
    helpers of item 17 among them), and their entry points default to
    CUDA and raise without it."""
    import importlib
    import torch
    names = {
        "parallel.halo": ("make_time_group", "sharded_fir"),
        "parallel.mesh": ("shard_channels", "gather_channels",
                          "sharded_demod_step"),
        "parallel.timeshard": ("diagonal_layout", "undiagonal",
                               "ring_stream_demod"),
        "util.ingest": ("DeviceFeeder", "read_chunks"),
        "fec.rs": ("torch_encode", "torch_syndromes"),
        "fec.prbs": ("derandomize_scan",),
        "dsp.math_utils": ("cmul", "parity_u32", "popcount_u32", "log2i"),
        "core.generic": ("ItemCounter", "decimate", "serialize"),
        "fec.deconv": ("BatchedDeconvolSync", "bytes_to_symbol_count"),
    }
    for mod, want in names.items():
        m = importlib.import_module(f"leansdr_tpu_torch.{mod}")
        assert all(hasattr(m, n) for n in want), (mod, want)
    if torch.cuda.is_available():
        return
    from leansdr_tpu_torch.parallel import group, multihost
    from leansdr_tpu_torch.util.ingest import DeviceFeeder
    for make in (lambda: DeviceFeeder([]), lambda: group.rank_device(0),
                 lambda: group.init(0, 1, "file:///nonexistent", "gloo")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    a = multihost.parse_args(["--world", "2"])
    assert (a.backend, a.device) == ("nccl", None)


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


def test_hard_fleet_entry_points_default_to_cuda():
    """The hard-decision fleet, its decoder and the coarse carrier search
    default to CUDA and raise without it."""
    import numpy as np
    import torch
    from leansdr_tpu_torch.dsp.acquisition import coarse_carrier_estimate
    from leansdr_tpu_torch.fec.deconv_device import DeviceDeconvolver
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
    if torch.cuda.is_available():
        return
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=False,
                   float_scale=75, exact_lut=False, viterbi=False,
                   sampler="linear")
    for make in (lambda: MultiDvbsReceiver(cfg, 2),
                 lambda: MultiDvbsReceiver(cfg, 2, native=False),
                 lambda: DeviceDeconvolver("1/2", 2, 4096, 2.0),
                 lambda: coarse_carrier_estimate(
                     np.zeros((4096, 2), np.float32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_unported_settings_raise():
    """The fleet's settings of once-unported paths reach them: item 20's
    constellations (8PSK 2/3 decoded as 4/6 on the banked ACS, 32 sync
    replicas), item 13's preprocessing (anf: the batched notch; cnr: the
    batched CNR estimator at Fs / Fm bandwidth, one block per Fs
    samples; want_spectrum: the batched spectrum), and item 10's the
    scan demod: sampler="nearest", exact_lut=True (with "rrc", the
    polyphase fir_sampler at Fs: 499 taps in steps of 32) and
    use_pallas=False. A combination the JAX fleet refuses (8PSK 1/2)
    raises its ValueError."""
    from leansdr_tpu_torch.dsp import blocks_device as bd
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
    base = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, float_scale=75,
                exact_lut=False, viterbi=True, sampler="rrc")
    with pytest.raises(ValueError, match="not suitable"):
        MultiDvbsReceiver(RxConfig(**(base | dict(
            constellation=Predef.PSK8))), 2, device="cpu")
    rx = MultiDvbsReceiver(RxConfig(**(base | dict(
        constellation=Predef.PSK8, rate="2/3"))), 2, device="cpu")
    assert (rx.rate, rx.deconv.kind) == ("4/6", "viterbi_banked")
    assert rx.deconv.plan.nsyncs == 32 and rx.params.nsymbols == 8
    assert rx.deconv.state["metric"].shape == (64, 2 * 32)
    # The CNR's band model needs Fs >= 4 Fm (as in the JAX fleet).
    with pytest.raises(ValueError, match="4x Fsignal"):
        MultiDvbsReceiver(RxConfig(**(base | dict(cnr=True))), 2,
                          device="cpu")
    rx = MultiDvbsReceiver(RxConfig(**(base | dict(
        Fm=1e6, anf=1, cnr=True, want_spectrum=True))), 2, device="cpu")
    assert isinstance(rx.notch, bd.BatchedAutoNotch) and rx.notch.nslots == 1
    assert isinstance(rx.cnr_est, bd.BatchedCnrFft)
    assert (rx.cnr_est.bw, rx.cnr_est.decimation) == (0.25, 4000000)
    assert isinstance(rx.spectrum, bd.BatchedSpectrum)
    assert rx.spectrum.decimation == 4000000
    for change, kw, sampler, exact, mf in (
            (dict(sampler="nearest"), {}, "nearest", False, False),
            (dict(exact_lut=True), {}, "rrc", True, False),
            ({}, dict(use_pallas=False), "linear", False, True)):
        rx = MultiDvbsReceiver(RxConfig(**(base | change)), 2, device="cpu",
                               **kw)
        assert not rx.use_pallas and rx._planes is None
        assert (rx.params.sampler, rx.params.exact_lut) == (sampler, exact)
        assert set(rx.state) >= {"mu", "phase", "freqw"}
        assert (rx.mf_taps is not None) == mf
        if exact:
            assert (len(rx.params.rrc_coeffs), rx.params.rrc_steps) == \
                (499, 32)
            assert rx.params.readahead == 16


def test_leandvb_help_runs_without_jax():
    """`python -m leansdr_tpu_torch.apps.leandvb -h` in a process where
    jax and leansdr_tpu cannot be imported."""
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'leansdr_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['leandvb', '-h']\n"
            "runpy.run_module('leansdr_tpu_torch.apps.leandvb', "
            "run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("Usage: leandvb") and "--device" in r.stdout


def test_slice9_entry_points_default_to_cuda(monkeypatch):
    """The device modulator, the candidate scan, the FM receiver and their
    CLIs default to CUDA and raise without it: `leanmlmrx` without
    `--device`, and `leansdrscan --device` on a template without a
    `--device NAME` (its own --device is the scan's boolean flag)."""
    import io
    import torch
    from leansdr_tpu_torch.apps import leanmlmrx, leansdrscan
    from leansdr_tpu_torch.pipelines.dvbs_tx_device import (DeviceModulator,
                                                            device_stimulus)
    from leansdr_tpu_torch.pipelines.mlm_rx import (Channel, MlmConfig,
                                                    MlmReceiver)
    from leansdr_tpu_torch.pipelines.scan_rx import CandidateScanReceiver
    from leansdr_tpu_torch.pipelines.tsgen import generate
    if torch.cuda.is_available():
        return

    class Stdin:
        buffer = io.BytesIO(bytes(4096))
    monkeypatch.setattr(sys, "stdin", Stdin)
    monkeypatch.setattr(sys, "stdout", type("Out", (), {
        "buffer": io.BytesIO()}))
    for make in (lambda: DeviceModulator(),
                 lambda: device_stimulus(generate(12)),
                 lambda: CandidateScanReceiver.grid(4e6, [2e6], ["1/2"]),
                 lambda: MlmReceiver(MlmConfig(channels=[Channel(98e6)])),
                 lambda: leanmlmrx.main(["98.4"]),
                 lambda: leansdrscan.main(["--device", "leandvb", "--sr",
                                           "1e6,2e6"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_single_carrier_entry_points_default_to_cuda():
    import torch
    from leansdr_tpu_torch.dsp.blocks_device import AutoNotch1
    from leansdr_tpu_torch.dsp.fir_kernel import FirFilterDevice
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    if torch.cuda.is_available():
        return
    for make in (lambda: DvbsReceiver(RxConfig(exact_lut=False)),
                 lambda: FirFilterDevice([1.0, 0.5], 2),
                 lambda: AutoNotch1(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("flags,item", [
    (["--awgn", "1"], "item 22"), (["--cnr", "-f", "8e6"], "item 13"),
    (["--fd-spectrum", "3"], "item 13"),
    (["--hs"], "item 12"), (["--hdlc", "--packetized"], "item 21"),
    (["--exact-lut"], "item 10"), (["--hard-metric"], "item 10"),
    (["--sampler", "nearest"], "item 10"), (["--hdlc"], "item 21"),
    (["--const", "8PSK", "--cr", "2/3", "--viterbi"], "item 20")])
def test_leandvb_unported_flags_raise(flags, item, tmp_path, monkeypatch):
    """The flags of items 10, 12, 13, 20, 21 and 22, once unported, reach
    their path: the CLI builds its receiver on the scan demod
    (--exact-lut, --hard-metric with the LUT's cost hardened to -1/0,
    --sampler nearest), the --hs demod, or the demod kernel with the
    --awgn noise stream, the --hdlc byte stages (--packetized: the
    16-bit frame lengths), the CNR estimator (--cnr, which needs Fs >=
    4 Fm) or the spectrum (--fd-spectrum, on a file's fd) before the
    demod, or 8PSK at 2/3 on the 2/3 trellis's banked ACS (16 sync
    replicas); and one 2048-sample u8 read (--anf 0) goes through it."""
    import io
    import numpy as np
    from leansdr_tpu_torch.apps import leandvb
    from leansdr_tpu_torch.pipelines import dvbs_rx
    built = []

    class Recorded(dvbs_rx.DvbsReceiver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(dvbs_rx, "DvbsReceiver", Recorded)
    raw = np.random.default_rng(0).integers(98, 158, 4096, dtype=np.uint8)

    class Stdin:
        buffer = io.BytesIO(raw.tobytes())
    monkeypatch.setattr(sys, "stdin", Stdin)
    monkeypatch.setattr(sys, "stdout", type("Out", (), {
        "buffer": io.BytesIO()}))
    if "--fd-spectrum" in flags:
        fd = os.open(tmp_path / "spectrum.txt", os.O_WRONLY | os.O_CREAT)
        flags = ["--fd-spectrum", str(fd)]
    assert leandvb.main(flags + ["--anf", "0", "--device", "cpu"]) == 0
    rx, = built
    if item == "item 13":
        # 2048 samples: no CNR value or spectrum line yet (one per Fs
        # samples), all of them in the estimator's backlog or phase.
        assert rx.use_pallas and rx._chunks_done == 1
        if rx.cfg.cnr:
            assert rx.cnr_est.b.backlog.buf.shape == (1, 2048, 2)
            assert rx.meas["cnr"] == [] and rx.spectrum is None
        else:
            assert (rx.spectrum.b.phase, rx.cnr_est) == (2048, None)
            assert rx.spectrum_lines == []
        return
    if item == "item 20":
        assert rx.use_pallas and rx._chunks_done == 1
        assert (rx.cstln.nsymbols, rx.deconv.rate) == (8, "2/3")
        assert (rx.deconv.nsyncs, rx.deconv.nshifts) == (16, 1)
        # ~1700 symbols: 13 chunks of 128 blocks decoded.
        assert len(rx.deconv.sym_backlog) < 128
        assert rx.deconv._dev_state[0].shape == (64, 16)
        return
    if item in ("item 21", "item 22"):
        assert rx.use_pallas and rx._chunks_done == 1
        if rx.cfg.hdlc:
            assert rx.noise_draws == 0
            assert rx.hdlc_sync.header16 == ("--packetized" in flags)
            assert sys.stdout.buffer.getvalue() == b""
        else:
            # 2048 samples of noise: two drand48 draws per attempt.
            assert rx.cfg.awgn == 1.0
            assert 2 * 2048 <= rx.noise_draws < 3 * 2048
        return
    if flags == ["--hs"]:
        assert rx.cfg.hs
        st, ra = rx.hs_state, 1
    else:
        assert not rx.use_pallas and rx._planes is None
        assert rx.params.exact_lut == (flags != ["--sampler", "nearest"])
        assert rx.params.sampler == ("nearest" if "nearest" in flags
                                     else "linear")
        costs = set(rx.tables["lut_cost"].tolist())
        assert (costs <= {-1, 0}) == (flags == ["--hard-metric"])
        st, ra = rx.state, rx.readahead
    # Whole chunks of 128 samples demodulated (the rest waits for more).
    assert int(st["meas_count"][0]) == (2048 - ra) // 128 * 128


ARGVS = [
    [],
    ["-f", "2400e3", "--sr", "2000e3", "--cr", "1/2"],
    ["--s16", "-f", "10e6", "--sr", "333e3", "--resample", "--cr", "3/4",
     "--resample-rej", "12", "--anf", "2"],
    ["--f32", "--float-scale", "75", "-f", "4e6", "--sr", "2e6", "--hq",
     "--cr", "7/8", "--tune", "5e3", "--drift", "--roll-off", "0.25"],
    ["--u8", "--viterbi", "--fastlock", "--sampler", "rrc", "--rrc-rej",
     "20", "--derotate", "-12e3", "--decim", "2", "--fd-pp", "9", "-d"],
    ["--const", "QPSK", "--cr", "2/3", "--fd-const", "4", "--fd-info", "2",
     "--json", "--no-exact-lut", "--anf", "0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "-")
def test_leandvb_parse_args_matches_jax(argv):
    """The port's parse_args gives the JAX CLI's RxConfig (exact_lut
    aside: the port's default is False, the JAX one resolves None from
    its backend) and the same options."""
    from leansdr_tpu.apps import leandvb as jcli
    from leansdr_tpu_torch.apps import leandvb as tcli
    jc, jo = jcli.parse_args(list(argv))
    tc, to = tcli.parse_args(list(argv))
    a, b = dict(jc.__dict__), dict(tc.__dict__)
    assert b.pop("exact_lut") is False
    a.pop("exact_lut")
    assert a.pop("constellation").name == b.pop("constellation").name
    assert a == b
    assert to.pop("device") is None
    assert jo == to
