"""The port's FFT coarse carrier search (leansdr_tpu_torch.dsp.
acquisition) against the JAX package's (leansdr_tpu/dsp/acquisition.py),
and `leandvb --acq` on it.

The port forms the 4096-point DFTs with dsp/fft_kernel.fft4096 (its
plain version `fft4096_ref` on the CPU; the frame count padded to a
multiple of 8 with zero frames), other sizes with torch.fft.fft; JAX
with its four-step `fft_planes`. Tolerance: the estimate (a bin index
over nfft * msymbols) exactly equal; the power spectra within 1e-4 of
their peak (two float32 DFTs summed in different orders, squared and
summed over frames).
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leansdr_tpu.dsp import acquisition as J

from leansdr_tpu_torch.dsp import acquisition as T
from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)


def _carrier(f, n, snr_db=10.0, seed=3, rate="1/2"):
    """n samples of the port's QPSK modulation (2 sps) shifted by f
    cycles/sample, with complex AWGN at snr_db per sample."""
    q = dvbs_tx.modulate(tsgen.generate(n // 3000 + 14),
                         dvbs_tx.TxConfig(rate=rate, interp=2))[:n]
    z = (q[:, 0] + 1j * q[:, 1]) * np.exp(2j * np.pi * f * np.arange(n))
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(np.abs(z) ** 2) * 10 ** (-snr_db / 10) / 2)
    z = z + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


@pytest.mark.parametrize("f,n,nfft", [
    (0.0, 8 * 4096, 4096), (1.3e-3, 8 * 4096, 4096),
    (-4.7e-3, 5 * 4096 + 1000, 4096), (2.2e-2, 13 * 4096, 4096),
    (-3.1e-2, 3 * 1024 + 7, 1024)])
def test_coarse_carrier_estimate_matches_jax(f, n, nfft):
    """Offsets from 0 to 3% of the sample rate, frame counts on and off
    the kernel's multiple of 8, and nfft 1024 (torch.fft.fft): the same
    estimate as JAX, within one bin of the true offset."""
    x = _carrier(f, n)
    want = J.coarse_carrier_estimate(x, msymbols=4, nfft=nfft)
    got = T.coarse_carrier_estimate(x, msymbols=4, nfft=nfft, device="cpu")
    assert got == want
    assert abs(got - f) <= 1.0 / (4 * nfft), (got, f)
    sj = np.asarray(J._power_spectrum_mth(jnp.asarray(x), 4, nfft))
    st = T._power_spectrum_mth(torch.from_numpy(x), 4, nfft).numpy()
    assert np.abs(st - sj).max() <= 1e-4 * sj.max()
    # A tensor input, and BPSK's square (m = 2).
    assert T.coarse_carrier_estimate(torch.from_numpy(x), msymbols=2,
                                     nfft=nfft, device="cpu") == \
        J.coarse_carrier_estimate(x, msymbols=2, nfft=nfft)


def test_coarse_carrier_estimate_checks_msymbols():
    with pytest.raises(ValueError, match="power of two"):
        T.coarse_carrier_estimate(np.zeros((4096, 2), np.float32), 3,
                                  device="cpu")


def test_leandvb_acq_seeds_tune(monkeypatch):
    """leandvb --acq -v --device cpu: the first block's estimate (the
    JAX one on the same samples) seeds --tune, and the receiver that
    decodes is rebuilt with it on the same device."""
    from leansdr_tpu_torch.apps import leandvb
    from leansdr_tpu_torch.pipelines import dvbs_rx
    made = []

    class Rx(dvbs_rx.DvbsReceiver):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device)
            made.append((cfg.Ftune, self))

    x = _carrier(2.5e-3, 4096, seed=5)
    est = J.coarse_carrier_estimate(x, msymbols=4)
    assert est != 0.0
    err = io.StringIO()
    monkeypatch.setattr(dvbs_rx, "DvbsReceiver", Rx)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(
        x.tobytes())))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(io.BytesIO()))
    monkeypatch.setattr(sys, "stderr", err)
    assert leandvb.main(["--f32", "--float-scale", "75", "-f", "4e6",
                         "--sr", "2e6", "--anf", "0", "--acq", "-v",
                         "--device", "cpu"]) == 0
    assert [f for f, _ in made] == [0.0, est * 4e6]
    assert made[-1][1].device.type == "cpu"
    assert f"coarse acquisition: {est * 4e6:+.0f} Hz" in err.getvalue()
