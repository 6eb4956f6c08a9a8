"""FFT-assisted coarse carrier acquisition (the counterpart of
leansdr_tpu/dsp/acquisition.py; an addition beyond the reference, which
acquires by PLL pull-in within clamped limits only).

For an M-PSK signal, raising samples to the Mth power collapses the
modulation and leaves a spectral line at M times the carrier offset; the
peak of the power spectrum summed over frames estimates the offset far
beyond the PLL's pull-in range.

The frames' DFT is `dsp/fft_kernel.fft4096` at nfft = 4096 (the CUDA
kernel on the card, its plain version `fft4096_ref` on the CPU); the
frame count is padded to a multiple of its FRAMES with zero frames,
which add nothing to the power sum. Other sizes use torch.fft.fft.
"""

import numpy as np
import torch

from .. import device as _dev
from . import fft_kernel


def _power_spectrum_mth(x: torch.Tensor, m: int, nfft: int) -> torch.Tensor:
    """[n, 2] float32 IQ -> [nfft] summed power spectrum of x**m over the
    whole nfft-sample frames."""
    n = (x.shape[0] // nfft) * nfft
    zr, zi = x[:n, 0], x[:n, 1]
    for _ in range(int(np.log2(m))):
        zr, zi = zr * zr - zi * zi, 2 * zr * zi
    zr, zi = zr.reshape(-1, nfft), zi.reshape(-1, nfft)
    if nfft == fft_kernel.N:
        pad = -zr.shape[0] % fft_kernel.FRAMES
        if pad:
            zeros = zr.new_zeros((pad, nfft))
            zr, zi = torch.cat([zr, zeros]), torch.cat([zi, zeros])
        fr, fi = fft_kernel.fft4096(zr.contiguous(), zi.contiguous())
    else:
        f = torch.fft.fft(torch.complex(zr, zi))
        fr, fi = f.real, f.imag
    return torch.sum(fr * fr + fi * fi, dim=0)


def coarse_carrier_estimate(iq, msymbols: int = 4, nfft: int = 4096,
                            device=None) -> float:
    """Estimate the carrier offset of an M-PSK signal in cycles/sample.

    iq: [n, 2] float32 (NumPy or a tensor), at least nfft samples.
    msymbols must be a power of two (2 = BPSK, 4 = QPSK/APSK outer).
    Resolution is 1/(msymbols*nfft) cycles/sample. Runs on `device`
    (default CUDA; "cpu" runs the plain FFT)."""
    if msymbols & (msymbols - 1):
        raise ValueError("msymbols must be a power of two")
    dev = _dev.resolve_device(device)
    x = torch.as_tensor(np.asarray(iq, np.float32) if not torch.is_tensor(iq)
                        else iq).to(dev, torch.float32)
    spec = _power_spectrum_mth(x, msymbols, nfft).cpu().numpy()
    peak = int(np.argmax(spec))
    f_m = peak / nfft
    if f_m >= 0.5:
        f_m -= 1.0
    return f_m / msymbols
