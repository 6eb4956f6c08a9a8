"""The port's preprocessing blocks against the JAX package: the device
auto-notch (leansdr_tpu_torch/dsp/blocks_device.py: `AutoNotch1` over
`BatchedAutoNotch`, `_notch_block`'s closed-form tracker, cuFFT's place
taken by torch.fft on the CPU) and the host `Rotator` / `decimate`
(dsp/blocks.py).

Tolerance: slot elections exactly equal; notch output within
1e-4 * max|x| and tracker state within 1e-4 * max|tracker| (float32: the
JAX package runs the tracker as an associative scan in float32 and its
DFT as float32 matrix products, the port runs the tracker's closed form
in float64 and torch.fft); the rotator's output bit for bit (same
table, same float32 products).
"""

import numpy as np
import pytest
import torch

from leansdr_tpu.dsp import blocks as jblocks
from leansdr_tpu.dsp import blocks_device as jbd

from leansdr_tpu_torch.dsp import blocks as tblocks
from leansdr_tpu_torch.dsp import blocks_device as tbd

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


def _tones(n, seed):
    """Noise plus two steady tones (bins 300 and 3000 of 4096) and one
    that jumps from bin 1200 to 1900 halfway."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    z = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 20
    z += 400 * np.exp(2j * np.pi * 300 * t / 4096)
    z += 250 * np.exp(2j * np.pi * 3000 * t / 4096 + 1.0)
    f = np.where(t < n // 2, 1200, 1900)
    z += 300 * np.exp(2j * np.pi * f * t / 4096)
    return z.astype(np.complex64)


@pytest.mark.parametrize("agc", [0.0, 50.0])
def test_auto_notch_matches_jax(agc):
    """AutoNotch1 with 3 slots, detection every 3 blocks (the CLI's
    cadence is every 1024 blocks), over uneven chunks: same slots after
    every call, same output and tracker state."""
    n = 14 * 4096 + 1000
    z = _tones(n, seed=5)
    j = jbd.AutoNotch1(3, agc)
    t = tbd.AutoNotch1(3, agc, device="cpu")
    j.b.decimation = t.b.decimation = 3 * 4096
    cuts = [0, 3000, 3000 + 2 * 4096, 9 * 4096 + 17, n]
    oj, ot = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        oj.append(j.process(z[a:b]))
        ot.append(t.process(z[a:b]))
        np.testing.assert_array_equal(j.b.slot_i, t.b.slot_i)
        assert len(oj[-1]) == len(ot[-1])
        np.testing.assert_allclose(
            t.b.estim, j.b.estim, rtol=0,
            atol=1e-4 * max(1.0, np.abs(j.b.estim).max()))
        np.testing.assert_allclose(t.b.gain, j.b.gain, rtol=1e-5)
    assert sorted(t.b.slot_i[0].tolist()) == [300, 1900, 3000]
    oj, ot = np.concatenate(oj), np.concatenate(ot)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-4 * np.abs(z).max())
    # The notch does its job: in the last block the steady tones' bins
    # are 20 dB below the input's (relative to the AGC gain).
    spec_in = np.abs(np.fft.fft(z[len(ot) - 4096:len(ot)]))
    spec_out = np.abs(np.fft.fft(ot[-4096:])) / t.b.gain[0]
    assert (spec_out[[300, 3000]] < 0.1 * spec_in[[300, 3000]]).all()


def test_closed_form_tracker_matches_recurrence():
    """first_order(u, y0, a) == the sequential recurrence in float64 at
    lengths that are and are not multiples of the 64-sample block."""
    rng = np.random.default_rng(1)
    for n in (1, 63, 64, 4096, 3 * 4096 + 5):
        u = rng.normal(size=(2, n))
        y0 = rng.normal(size=2)
        want = np.empty_like(u)
        y = y0.copy()
        for i in range(n):
            y = 0.998 * y + u[:, i]
            want[:, i] = y
        got = tbd.first_order(torch.from_numpy(u), torch.from_numpy(y0),
                              0.998).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_rotator_and_decimate_match_jax():
    rng = np.random.default_rng(2)
    z = ((rng.normal(size=5000) + 1j * rng.normal(size=5000)) * 30
         ).astype(np.complex64)
    j, t = jblocks.Rotator(-0.0123), tblocks.Rotator(-0.0123)
    for a, b in ((0, 1000), (1000, 1777), (1777, 5000)):
        np.testing.assert_array_equal(t.process(z[a:b]), j.process(z[a:b]))
        assert t.index == j.index
    np.testing.assert_array_equal(tblocks.decimate(z, 7),
                                  jblocks.decimate(z, 7))
