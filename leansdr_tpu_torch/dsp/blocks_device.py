"""Device-batched preprocessing for a channel batch (the counterpart of
leansdr_tpu/dsp/blocks_device.py, with leansdr_tpu/dsp/fft.py's DFT as
`torch.fft`): the auto-notch, the CNR estimator, the spectrum and the
carrier-tracked decimating FIR, and their single-carrier adapters.

auto_notch (reference sdr.h:46-154): every `decimation` samples a
4096-point FFT finds the nslots strongest bins (zeroing +-1 neighbours
between picks); per-sample first-order trackers follow each tone and
subtract it; the block doubles as a crude AGC toward agc_rms_setpoint.
Slot election and the EMA bookkeeping stay on the host at block rate;
the FFT, the trackers and the subtraction run on the device.

The tracker y_t = (1-k) y_{t-1} + k bb_t, which the JAX package runs as
an associative scan, is computed here in closed form: within blocks of
64 samples a lower-triangular Toeplitz product with powers of (1-k),
then the same recurrence one level up over the block ends with (1-k)^64
(0.998^64 ~ 0.88), recursively, all in float64, so no power underflows
into the result and no TF32 product is involved. Between two detections
the slots do not change and the tones' phasors repeat every 4096
samples, so the whole run of blocks is one sequence: one device pass per
run instead of one per block.

cnr_fft (sdr.h:1273-1345, `BatchedCnrFft`) and spectrum (sdr.h:1347-1404,
`BatchedSpectrum`) take the power spectrum of the one block in
`decimation` samples that triggers (cuFFT on the device) and keep their
EMA and the band model on the host, as the JAX classes do.
`BatchedFirFilter` (fir_filter, dsp.h:219-285) is plain torch ops: the
JAX class has no runtime consumer (the receivers' --resample runs
dsp/fir_kernel.py).

Inputs are [C, n, 2] float32 (re, im) planes.
"""

from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev

_L = 64                  # closed-form block length of the tracker


def _batched_power(blocks: np.ndarray, nfft: int, device) -> np.ndarray:
    """[C, B, nfft, 2] float32 -> power [C, B, nfft] (cuFFT on CUDA)."""
    x = torch.from_numpy(np.ascontiguousarray(blocks, np.float32)).to(device)
    y = torch.fft.fft(torch.complex(x[..., 0], x[..., 1]), n=nfft, dim=-1)
    return (y.real * y.real + y.imag * y.imag).cpu().numpy()


@lru_cache(maxsize=None)
def _powers(a: float, n: int, device):
    """(W [n, n] with W[i, m] = a^(i-m) for m <= i else 0, P [n] = a^(i+1))
    in float64 on `device`, cached."""
    i = np.arange(n)
    d = i[:, None] - i[None, :]
    W = np.where(d >= 0, a ** np.maximum(d, 0), 0.0)
    return (torch.from_numpy(W).to(device),
            torch.from_numpy(a ** (i + 1.0)).to(device))


def first_order(u: torch.Tensor, y0: torch.Tensor, a: float) -> torch.Tensor:
    """y_t = a*y_{t-1} + u_t along the last axis, y_{-1} = y0 (float64
    tensors u [..., n], y0 [...]): the blocked closed form."""
    n = u.shape[-1]
    if n <= _L:
        W, P = _powers(a, n, u.device)
        return u @ W.T + y0[..., None] * P
    nb = -(-n // _L)
    if nb * _L != n:
        u = torch.nn.functional.pad(u, (0, nb * _L - n))
    W, P = _powers(a, _L, u.device)
    local = u.reshape(*u.shape[:-1], nb, _L) @ W.T       # from zero state
    ends = first_order(local[..., -1], y0, a ** _L)       # true block ends
    prev = torch.cat([y0[..., None], ends[..., :-1]], dim=-1)
    y = local + prev[..., None] * P
    return y.reshape(*u.shape[:-1], nb * _L)[..., :n]


def _notch_block(block: torch.Tensor, slot_i: torch.Tensor,
                 estim: torch.Tensor, gain: torch.Tensor, k: float,
                 nfft: int):
    """Track and subtract each channel's slots over a run of whole
    blocks with unchanged slots.

    block [C, m, 2] (m a multiple of nfft); slot_i [C, S] int (-1 =
    empty); estim [C, S, 2]; gain [C]. Returns (out [C, m, 2], new estim
    [C, S, 2]), float32. Like the JAX version, empty slots are tracked
    too (at bin -1) and only active slots are subtracted."""
    m = block.shape[1]
    t = (torch.arange(m, device=block.device) % nfft).to(torch.float32)
    ang = (2 * np.pi / nfft) * slot_i.to(torch.float32)[..., None] \
        * t[None, None, :]                                # [C, S, m]
    ejr = torch.cos(ang)
    eji = torch.sin(ang)
    xr, xi = block[:, None, :, 0], block[:, None, :, 1]
    br = xr * ejr + xi * eji
    bi = xi * ejr - xr * eji
    e64 = estim.to(torch.float64)
    yr = first_order((k * br).to(torch.float64), e64[..., 0],
                     1 - k).to(torch.float32)
    yi = first_order((k * bi).to(torch.float64), e64[..., 1],
                     1 - k).to(torch.float32)
    active = (slot_i >= 0).to(torch.float32)[..., None]
    sub_r = torch.sum(active * (yr * ejr - yi * eji), dim=1)
    sub_i = torch.sum(active * (yr * eji + yi * ejr), dim=1)
    out = torch.stack([block[:, :, 0] - sub_r, block[:, :, 1] - sub_i],
                      dim=-1) * gain[:, None, None]
    return out, torch.stack([yr[..., -1], yi[..., -1]], dim=-1)


class _Backlog:
    def __init__(self, nchan):
        self.buf = np.empty((nchan, 0, 2), np.float32)

    def add(self, x):
        self.buf = np.concatenate([self.buf, np.asarray(x, np.float32)],
                                  axis=1)

    def take(self, nfft):
        """Return [C, B, nfft, 2] whole blocks, keep the remainder."""
        B = self.buf.shape[1] // nfft
        if not B:
            return None
        blk = self.buf[:, :B * nfft].reshape(
            self.buf.shape[0], B, nfft, 2)
        self.buf = self.buf[:, B * nfft:]
        return blk


class BatchedAutoNotch:
    """auto_notch (sdr.h:46-154) over a channel batch: FFT detection on
    the device, tone tracking in closed form, subtraction on the device.
    Entry points run on `device` (default CUDA)."""

    NFFT = 4096

    def __init__(self, nchan: int, nslots: int,
                 agc_rms_setpoint: float = 0.0,
                 decimation: int = 1024 * 4096, k: float = 0.002,
                 device=None):
        self.device = _dev.resolve_device(device)
        self.nchan = nchan
        self.nslots = nslots
        self.agc_rms_setpoint = agc_rms_setpoint
        self.decimation = decimation
        self.k = k
        self.slot_i = np.full((nchan, nslots), -1, np.int32)
        self.estim = np.zeros((nchan, nslots, 2), np.float32)
        self.gain = np.ones(nchan, np.float32)
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def _detect(self, block: np.ndarray, power: np.ndarray):
        if self.agc_rms_setpoint:
            m2 = (block[..., 0] ** 2 + block[..., 1] ** 2).sum(axis=1)
            rms = np.sqrt(m2 / self.NFFT)
            nz = rms > 0
            self.gain[nz] = (self.gain[nz] * 0.9
                             + (self.agc_rms_setpoint / rms[nz]) * 0.1)
        amp = np.sqrt(power).copy()                     # [C, NFFT]
        for s in range(self.nslots):
            iamax = amp.argmax(axis=1)                  # [C]
            changed = iamax != self.slot_i[:, s]
            self.slot_i[:, s] = iamax
            self.estim[changed, s] = 0
            cols = np.stack([iamax - 1, iamax, iamax + 1], 1)
            cols = np.clip(cols, 0, self.NFFT - 1)
            np.put_along_axis(amp, cols, 0.0, axis=1)

    def _notch_run(self, blocks: np.ndarray) -> np.ndarray:
        """Notch a run [C, L, NFFT, 2] of blocks with unchanged slots."""
        C, L = blocks.shape[:2]
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(
            blocks.reshape(C, L * self.NFFT, 2))).to(dev)
        out, est = _notch_block(x, torch.from_numpy(self.slot_i).to(dev),
                                torch.from_numpy(self.estim).to(dev),
                                torch.from_numpy(self.gain).to(dev),
                                self.k, self.NFFT)
        self.estim = est.cpu().numpy()
        return out.cpu().numpy()

    def process(self, x) -> np.ndarray:
        """x: [C, n, 2] -> notch-filtered [C, m, 2] (whole blocks)."""
        self.backlog.add(x)
        blocks = self.backlog.take(self.NFFT)
        if blocks is None:
            return np.empty((self.nchan, 0, 2), np.float32)
        outs = []
        start = 0
        for b in range(blocks.shape[1]):
            self.phase += self.NFFT
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                if b > start:
                    outs.append(self._notch_run(blocks[:, start:b]))
                start = b
                power = _batched_power(blocks[:, b:b + 1], self.NFFT,
                                       self.device)[:, 0]
                self._detect(blocks[:, b], power)
        outs.append(self._notch_run(blocks[:, start:]))
        return np.concatenate(outs, axis=1)


def _triggered(est, x, nfft: int):
    """Feed x [C, n, 2] to a spectral estimator `est` (its backlog,
    phase, decimation, kavg, avgpower, device) and yield once for each
    whole nfft-block that triggers (one per `decimation` samples), after
    folding that block's power spectrum (on the device) into the EMA
    est.avgpower [C, nfft]."""
    est.backlog.add(x)
    blocks = est.backlog.take(nfft)
    for b in range(0 if blocks is None else blocks.shape[1]):
        est.phase += nfft
        if est.phase >= est.decimation:
            est.phase -= est.decimation
            p = _batched_power(blocks[:, b:b + 1], nfft, est.device)[:, 0]
            if est.avgpower is None:
                est.avgpower = p.copy()
            est.avgpower = est.avgpower * (1 - est.kavg) + p * est.kavg
            yield


class BatchedSpectrum:
    """spectrum (sdr.h:1347-1404) over a channel batch: EMA'd dB spectra
    in [positive-half | negative-half] order, the triggering block's
    power spectrum on the device. Entry points run on `device`."""

    NFFT = 1024

    def __init__(self, nchan: int, decimation: int = 1 << 20,
                 kavg: float = 0.1, device=None):
        self.device = _dev.resolve_device(device)
        self.nchan = nchan
        self.decimation = decimation
        self.kavg = kavg
        self.avgpower = None            # [C, NFFT]
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def process(self, x) -> list:
        """x: [C, n, 2]. Returns a list of [C, NFFT] dB lines."""
        half = self.NFFT // 2
        return [np.concatenate([10 * np.log10(self.avgpower[:, half:]),
                                10 * np.log10(self.avgpower[:, :half])],
                               axis=1).astype(np.float32)
                for _ in _triggered(self, x, self.NFFT)]


class BatchedCnrFft:
    """cnr_fft (sdr.h:1273-1345) over a channel batch: the band-model CNR
    around each channel's tracked carrier, from an EMA'd nfft-point power
    spectrum (the triggering block's FFT on the device)."""

    def __init__(self, nchan: int, bandwidth: float, nfft: int = 4096,
                 decimation: int = 1 << 20, kavg: float = 0.1,
                 device=None):
        if bandwidth > 0.25:
            raise ValueError("CNR estimator requires Fsampling > 4x Fsignal")
        self.device = _dev.resolve_device(device)
        self.nchan = nchan
        self.bw = bandwidth
        self.nfft = nfft
        self.decimation = decimation
        self.kavg = kavg
        self.avgpower = None            # [C, nfft]
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def _cnr(self, freq_tap: np.ndarray):
        n = self.nfft
        icf = np.floor(freq_tap * n + 0.5).astype(np.int64)   # [C]
        bwslots = int((self.bw / 4) * n)
        if not bwslots:
            return None

        def avg(lo, hi):
            idx = (icf[:, None] + np.arange(lo, hi + 1)[None, :]) & (n - 1)
            return np.take_along_axis(self.avgpower, idx, axis=1).mean(1)

        c2plusn2 = avg(-bwslots, bwslots)
        n2 = (avg(-bwslots * 4, -bwslots * 3)
              + avg(bwslots * 3, bwslots * 4)) / 2
        c2 = c2plusn2 - n2
        ok = (c2 > 0) & (n2 > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = 10 * np.log10(c2 / n2)
        return np.where(ok, v, -50.0).astype(np.float32)

    def process(self, x, freq_tap=None) -> list:
        """x: [C, n, 2]; freq_tap: [C] tracked carrier (cycles/sample).
        Returns a list of [C] CNR vectors (dB)."""
        if freq_tap is None:
            freq_tap = np.zeros(self.nchan, np.float32)
        out = (self._cnr(np.asarray(freq_tap))
               for _ in _triggered(self, x, self.nfft))
        return [v for v in out if v is not None]


def _tracking_fir(taps: tuple, decim: int, count: int, freq: torch.Tensor,
                  buf: torch.Tensor) -> torch.Tensor:
    """Decimating carrier-tracked FIR over a channel batch (fir_filter,
    dsp.h:219-285): out[c, j] = sum_k taps_rot[c, k] * buf[c, n+j*d-k]
    with taps_rot[k] = taps[k] * exp(i*2pi*freq_c*(k - n//2)), in the
    JAX version's float32 order (tap by tap).

    buf [C, m, 2] float32 with m >= n + count*decim; freq [C] float32
    cycles/sample. Returns [C, count, 2]."""
    c = torch.tensor(taps, dtype=torch.float32, device=buf.device)
    nt = c.shape[0]
    k = torch.arange(nt, dtype=torch.float32, device=buf.device) - nt // 2
    ang = (2 * np.pi) * freq[:, None] * k[None]
    cr = c[None] * torch.cos(ang)                          # [C, nt]
    ci = c[None] * torch.sin(ang)
    xr, xi = buf[:, :, 0], buf[:, :, 1]
    zr = torch.zeros((buf.shape[0], count), dtype=torch.float32,
                     device=buf.device)
    zi = zr
    for kk in range(nt):
        off = nt - kk
        sr = xr[:, off:off + count * decim:decim]
        si = xi[:, off:off + count * decim:decim]
        wr, wi = cr[:, kk:kk + 1], ci[:, kk:kk + 1]
        zr = zr + wr * sr - wi * si
        zi = zi + wr * si + wi * sr
    return torch.stack([zr, zi], dim=-1)


class BatchedFirFilter:
    """fir_filter (dsp.h:219-285) over a channel batch: per-channel
    carrier-rotated taps, decimation, streaming history (the JAX class
    of the same name, in torch ops)."""

    def __init__(self, nchan: int, coeffs, decim: int = 1, device=None):
        self.device = _dev.resolve_device(device)
        self.taps = tuple(float(v) for v in np.asarray(coeffs))
        self.n = len(self.taps)
        self.nchan = nchan
        self.decim = decim
        self.hist = np.zeros((nchan, self.n, 2), np.float32)
        self._primed = False

    def process(self, x, freq_tap=None) -> np.ndarray:
        """x: [C, n, 2]; freq_tap: [C] tracked carrier (cycles/sample).
        Returns decimated [C, m, 2]."""
        if freq_tap is None:
            freq_tap = np.zeros(self.nchan, np.float32)
        buf = np.concatenate([self.hist, np.asarray(x, np.float32)],
                             axis=1)
        if not self._primed:
            buf = buf[:, self.n:]
            self._primed = True
        count = (buf.shape[1] - self.n) // self.decim
        if count <= 0:
            keep = min(buf.shape[1], self.n + self.decim - 1)
            self.hist = buf[:, -keep:]
            return np.empty((self.nchan, 0, 2), np.float32)
        dev = self.device
        out = _tracking_fir(
            self.taps, self.decim, count,
            torch.from_numpy(np.asarray(freq_tap, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(buf)).to(dev))
        self.hist = buf[:, count * self.decim:]
        return out.cpu().numpy()


def _c2p(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)[None]


class AutoNotch1:
    """A complex-stream interface over BatchedAutoNotch(nchan=1): the
    single-carrier receiver's notch."""

    def __init__(self, nslots: int, agc_rms_setpoint: float = 0.0,
                 device=None):
        self.b = BatchedAutoNotch(1, nslots, agc_rms_setpoint,
                                  device=device)

    def process(self, z: np.ndarray) -> np.ndarray:
        y = self.b.process(_c2p(np.asarray(z, np.complex64)))[0]
        return (y[:, 0] + 1j * y[:, 1]).astype(np.complex64)


class CnrFft1:
    """A complex-stream interface over BatchedCnrFft(nchan=1): the
    single-carrier receiver's --cnr (blocks.CnrFft's interface)."""

    def __init__(self, bandwidth: float, decimation: int = 1 << 20,
                 device=None):
        self.b = BatchedCnrFft(1, bandwidth, decimation=decimation,
                               device=device)

    def process(self, z, freq_tap: float = 0.0):
        vs = self.b.process(_c2p(np.asarray(z, np.complex64)),
                            np.asarray([freq_tap], np.float32))
        return [float(v[0]) for v in vs]


class Spectrum1:
    """A complex-stream interface over BatchedSpectrum(nchan=1): the
    single-carrier receiver's --fd-spectrum (blocks.Spectrum's
    interface)."""

    def __init__(self, decimation: int = 1 << 20, device=None):
        self.b = BatchedSpectrum(1, decimation=decimation, device=device)

    def process(self, z):
        return [line[0] for line in
                self.b.process(_c2p(np.asarray(z, np.complex64)))]
