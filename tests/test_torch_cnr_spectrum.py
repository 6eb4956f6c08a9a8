"""--cnr, --fd-spectrum and the fleet's preprocessing (ROADMAP queue 1
item 13) against the JAX package on the CPU:

  * the batched estimators `BatchedCnrFft` and `BatchedSpectrum`, their
    single-carrier adapters `CnrFft1` and `Spectrum1`, and the
    carrier-tracked decimating `BatchedFirFilter` against the JAX classes
    of leansdr_tpu/dsp/blocks_device.py (its FFT a matmul DFT, the port's
    torch.fft);
  * the single carrier's preprocessing chain (notch, derotation, CNR,
    spectrum, in JAX's order, one block per Fs samples) against the JAX
    CPU receiver's, which runs the host blocks.CnrFft / blocks.Spectrum
    (numpy.fft);
  * the fleet with anf, cnr and want_spectrum against the JAX fleet;
  * `leandvb --cnr --fd-spectrum` against the JAX CLI's output.

Tolerances: power spectra in float32 from two FFTs that sum in other
orders; CNR and spectrum values within 1e-3 dB of each other (a CNR is
10 log10 of a ratio of band means; 1e-3 dB is a relative 2.3e-4), CLI
lines within one unit of their last printed digit (CNR 0.1 dB, SPECTRUM
0.001 dB); the FIR within 1e-5 of the input's largest magnitude.
Counts of CNR values and spectrum lines, and the TS, are equal.
"""

import io
import os
import sys

import numpy as np
import torch

from leansdr_tpu_torch.dsp import blocks_device as tbd
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.pipelines import multi_rx as TM

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

DB_TOL = 1e-3


def _carriers(C, n, seed):
    """[C, n, 2] float32: per channel QPSK symbols held for 8 samples
    (a band ~1/8 wide) around its own carrier, white noise 20 dB down
    and a CW tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    out = []
    for c in range(C):
        f = (c - C / 2) * 0.01
        sym = np.exp(2j * np.pi * rng.integers(0, 4, n // 8 + 1) / 4)
        z = np.repeat(sym, 8)[:n] * np.exp(2j * np.pi * f * t)
        z = z + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        z = z + 0.05 * np.exp(2j * np.pi * (0.2 + 0.01 * c) * t)
        out.append(np.stack([z.real, z.imag], -1))
    return (np.stack(out) * 40).astype(np.float32)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(a - b).max() if a.size else 0.0
    assert d <= tol, f"{what}: max |diff| {d} > {tol}"


def test_batched_estimators_match_jax():
    """BatchedCnrFft (3 channels, each its own carrier and freq_tap) and
    BatchedSpectrum over uneven reads with decimation 3 blocks, then
    CnrFft1 and Spectrum1 on one channel: the same number of CNR vectors
    and spectrum lines, values within 1e-3 dB, the EMA'd power within a
    relative 1e-5; the estimators' phase and backlog equal."""
    from leansdr_tpu.dsp import blocks_device as jbd
    C, n = 3, 61000
    x = _carriers(C, n, seed=1)
    taps = np.array([-0.015, 0.0, 0.01], np.float32)
    jc = jbd.BatchedCnrFft(C, 0.2, decimation=3 * 4096)
    tc = tbd.BatchedCnrFft(C, 0.2, decimation=3 * 4096, device="cpu")
    js = jbd.BatchedSpectrum(C, decimation=3 * 1024)
    ts = tbd.BatchedSpectrum(C, decimation=3 * 1024, device="cpu")
    jv, tv, jl, tl = [], [], [], []
    for lo, hi in ((0, 5000), (5000, 30000), (30000, n)):
        jv += jc.process(x[:, lo:hi], taps)
        tv += tc.process(x[:, lo:hi], taps)
        jl += js.process(x[:, lo:hi])
        tl += ts.process(x[:, lo:hi])
    assert len(tv) == len(jv) == 4 and len(tl) == len(jl) == 19
    _close(jv, tv, DB_TOL, "BatchedCnrFft dB")
    _close(jl, tl, DB_TOL, "BatchedSpectrum dB")
    for j, t in ((jc, tc), (js, ts)):
        _close(t.avgpower / j.avgpower, np.ones_like(j.avgpower), 1e-5,
               "avgpower")
        assert t.phase == j.phase
        np.testing.assert_array_equal(j.backlog.buf, t.backlog.buf)
    z = x[1, :, 0] + 1j * x[1, :, 1]
    j1, t1 = jbd.CnrFft1(0.2), tbd.CnrFft1(0.2, decimation=4096,
                                           device="cpu")
    j2, t2 = jbd.Spectrum1(), tbd.Spectrum1(decimation=2048, device="cpu")
    j1.decimation = 4096
    j2.decimation = 2048
    a, b = j1.process(z, 0.01), t1.process(z, 0.01)
    assert len(a) == len(b) == 14 and all(type(v) is float for v in b)
    _close(a, b, DB_TOL, "CnrFft1 dB")
    a, b = j2.process(z), t2.process(z)
    assert len(a) == len(b) == 29 and b[0].shape == (1024,)
    _close(a, b, DB_TOL, "Spectrum1 dB")


def test_batched_fir_filter_matches_jax():
    """BatchedFirFilter (31 taps, decimation 3, per-channel carrier
    taps) over four reads, the first shorter than the filter: outputs
    within 1e-5 of max|x| of the JAX class's, the history equal."""
    from leansdr_tpu.dsp import blocks_device as jbd
    C = 3
    x = _carriers(C, 9000, seed=2)
    coeffs = np.hanning(33)[1:-1] / np.hanning(33)[1:-1].sum()
    j = jbd.BatchedFirFilter(C, coeffs, decim=3)
    t = tbd.BatchedFirFilter(C, coeffs, decim=3, device="cpu")
    freq = np.array([0.0, 0.013, -0.021], np.float32)
    for lo, hi in ((0, 20), (20, 2000), (2000, 2001), (2001, 9000)):
        a = j.process(x[:, lo:hi], freq)
        b = t.process(x[:, lo:hi], freq)
        _close(a, b, 1e-5 * np.abs(x).max(), f"FIR [{lo}, {hi})")
        np.testing.assert_array_equal(j.hist, t.hist)


def test_single_carrier_preprocess_matches_jax():
    """DvbsReceiver's preprocessing with --anf 1 --derotate --cnr
    --fd-spectrum at Fs = 65536, Fm = 16384 (the band model needs Fs >=
    4 Fm; one CNR value and one spectrum line per 65536 samples) over
    uneven reads of 5 x 65536 samples, against the JAX CPU receiver's
    (host blocks.CnrFft / blocks.Spectrum, numpy.fft): the notched,
    derotated output within 1e-4 of max|x|, the same count of CNR values
    (freq_tap 0: no demod has run) and spectrum lines, each within 1e-3
    dB."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    kw = dict(Fs=65536.0, Fm=16384.0, anf=1, Fderot=1024.0, cnr=True,
              want_spectrum=True)
    j = J.DvbsReceiver(J.RxConfig(constellation=JP.QPSK, **kw))
    t = TR.DvbsReceiver(TR.RxConfig(exact_lut=False, **kw), device="cpu")
    assert t.cnr_est.b.decimation == t.spectrum.b.decimation == 65536
    x = _carriers(1, 5 * 65536, seed=3)[0]
    for lo, hi in ((0, 40000), (40000, 200000), (200000, 5 * 65536)):
        a, b = j._preprocess(x[lo:hi]), t._preprocess(x[lo:hi])
        _close(a, b, 1e-4 * np.abs(x).max(), "preprocessed IQ")
    assert len(t.meas["cnr"]) == len(j.meas["cnr"]) == 5
    _close(j.meas["cnr"], t.meas["cnr"], DB_TOL, "meas cnr")
    assert len(t.spectrum_lines) == len(j.spectrum_lines) == 5
    _close(j.spectrum_lines, t.spectrum_lines, DB_TOL, "spectrum lines")


def test_fleet_preprocessing_matches_jax():
    """MultiDvbsReceiver with anf=1, cnr and want_spectrum (2 carriers at
    Fs = 4096, Fm = 1024, hard decisions, the scan demod on both sides)
    against the JAX fleet over three reads of 4096: the notch before the
    estimators, the CNR at each carrier's freqw / 65536; the same count
    of CNR vectors and spectrum lines, within 1e-3 dB."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    from leansdr_tpu.pipelines import multi_rx as JMr
    kw = dict(Fs=4096.0, Fm=1024.0, anf=1, cnr=True, want_spectrum=True,
              exact_lut=True, fastlock=True, float_scale=1.0)
    C = 2
    j = JMr.MultiDvbsReceiver(J.RxConfig(constellation=JP.QPSK, **kw), C,
                              chunk_samples=4096)
    t = TM.MultiDvbsReceiver(TR.RxConfig(**kw), C, chunk_samples=4096,
                             device="cpu")
    x = _carriers(C, 3 * 4096, seed=4)
    freqs = []
    f = t.cnr_est.process

    def seen(iq, taps):
        freqs.append(np.array(taps))
        return f(iq, taps)
    t.cnr_est.process = seen
    before = []
    for k in range(3):
        j.process(x[:, k * 4096:(k + 1) * 4096])
        before.append(t.state["freqw"].numpy() / 65536.0)
        t.process(x[:, k * 4096:(k + 1) * 4096])
    assert len(t.cnr) == len(j.cnr) == 3 and t.cnr[0].shape == (C,)
    _close(j.cnr, t.cnr, DB_TOL, "fleet cnr")
    assert len(t.spectrum_lines) == len(j.spectrum_lines) == 3
    _close(j.spectrum_lines, t.spectrum_lines, DB_TOL, "fleet spectrum")
    # The carrier of each read's CNR: the demod state's freqw before it.
    assert (freqs[0] == 0).all() and (freqs[2] != 0).all()
    np.testing.assert_array_equal(np.array(freqs), np.array(before))
    np.testing.assert_array_equal(j.notch.slot_i, t.notch.slot_i)


def _run_cli(main, argv, raw, tmp_path, tag, monkeypatch):
    """main(argv + fds) on `raw` as stdin: (stdout bytes, info text,
    spectrum text)."""
    info, spec = tmp_path / f"{tag}.info", tmp_path / f"{tag}.spec"
    fi = os.open(info, os.O_WRONLY | os.O_CREAT)
    fs = os.open(spec, os.O_WRONLY | os.O_CREAT)
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", type("In", (), {
        "buffer": io.BytesIO(raw)}))
    monkeypatch.setattr(sys, "stdout", type("Out", (), {"buffer": out}))
    assert main(argv + ["--fd-info", str(fi), "--fd-spectrum",
                        str(fs)]) == 0
    for fd in (fi, fs):
        try:
            os.fsync(fd)
        except OSError:
            pass
    import gc
    gc.collect()                    # the writers' files close and flush
    return out.getvalue(), info.read_text(), spec.read_text()


def test_leandvb_cnr_fd_spectrum_matches_jax(tmp_path, monkeypatch):
    """`leandvb --f32 -f 4096 --sr 1024 --cnr --fd-spectrum FD --fd-info
    FD --exact-lut --anf 0` on 12288 samples (one CNR value per 4096
    samples, one spectrum line per four 1024-point blocks), the port's
    CLI against the JAX CLI: the same CNR and SPECTRUM lines, each value
    within one unit of its last printed digit, the same TS."""
    from leansdr_tpu.apps import leandvb as jcli
    from leansdr_tpu_torch.apps import leandvb as tcli
    x = _carriers(1, 12288, seed=5)[0] / 40
    argv = ["--f32", "--float-scale", "75", "-f", "4096", "--sr", "1024",
            "--cnr", "--exact-lut", "--anf", "0"]
    jo, ji, js = _run_cli(jcli.main, argv, x.tobytes(), tmp_path, "jax",
                          monkeypatch)
    to, ti, ts = _run_cli(tcli.main, argv + ["--device", "cpu"],
                          x.tobytes(), tmp_path, "port", monkeypatch)
    assert to == jo

    def lines(text, tag):
        return [np.array(l.split()[1:], np.float64)
                for l in text.splitlines() if l.startswith(tag + " ")]
    jc, tc = lines(ji, "CNR"), lines(ti, "CNR")
    assert len(tc) == len(jc) == 3
    _close(jc, tc, 0.1 + 1e-9, "CNR lines")
    jl, tl = lines(js, "SPECTRUM"), lines(ts, "SPECTRUM")
    assert len(tl) == len(jl) == 3 and tl[0][0] == 1024
    _close(jl, tl, 0.001 + 1e-9, "SPECTRUM lines")
