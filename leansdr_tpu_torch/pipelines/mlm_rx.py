"""Multi-channel FM receiver (the leanmlmrx equivalent, reference
src/apps/leanmlmrx.cc; the counterpart of leansdr_tpu/pipelines/mlm_rx.py).

The reference's pthread pipeline (reader -> 2 FFT workers with 1024-job
ring buffers and busy-wait flags -> joiner) collapses into ONE batched
DFT over a [nframes, N] window tensor plus vectorized per-channel math,
all on the device (`device`, default CUDA):

  windows    x[k*stride : k*stride+N] for stride = round(Fs/Fq), as a
             strided view of the samples (unfold: no host fancy index)
  channelize batched DFT (dsp/fft.fft_planes: float32 matmuls, TF32 off),
             gather 2 adjacent bins per channel, apply the precomputed
             2x2x2 combining weights (leanmlmrx.cc:575-615), overflow
             halving, 8-bit-quantized atan2 -> u16 phase
  discriminate  dph = ph - prevph - derot (u16 -> s16)
  audio      squelch RMS gate, channel mixdown with 1/sqrt(n) scaling,
             one-pole de-emphasis, +-decimation to Fau, int8 out

Only the de-emphasis filter and squelch EMA are sequential — first-order
recurrences evaluated with associative scans (dsp/blocks.py
`_first_order_scan`, JAX's odd/even recursion) at audio rate. Every
stage is torch ops, float32 where JAX computes in float32 and float64
where its NumPy stages compute in float64 (the mixdown scale), so the
CPU and the card differ only where the DFT's sums round differently.
The JAX receiver reaches no Pallas kernel; neither does this one.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as _dev
from ..dsp.blocks import _first_order_scan
from ..dsp.fft import fft_planes
from ..dsp.math_utils import atan2_poly

MAXCHANS = 201
_U16_PER_RAD = float(np.float32(65536 / (2 * np.pi)))


@dataclass
class Channel:
    F: float
    enabled: bool = True


@dataclass
class MlmConfig:
    Fs: float = 25.6e6
    Fc: float = 98e6
    Fq: float = 0.0          # quadrature rate; 0 = autoselect
    maxdev: float = 75e3
    deemph: float = 50e-6
    N: int = 64
    channels: list = field(default_factory=list)
    squelch: float = 0.0
    Fau: float = 44100.0
    wav: bool = False


def resolve_rates(cfg: MlmConfig):
    """Fq/Fau/audiodecim selection (leanmlmrx.cc:530-559)."""
    Fq, Fau = cfg.Fq, cfg.Fau
    if not Fq:
        if Fau:
            if Fau > 2 * cfg.maxdev:
                audiodecim = -int(np.floor(Fau / (2 * cfg.maxdev)))
                Fq = Fau / (-audiodecim)
            else:
                audiodecim = int(np.ceil((2 * cfg.maxdev) / Fau))
                Fq = Fau * audiodecim
        else:
            Fq = cfg.Fs / cfg.N
            Fau = Fq
            audiodecim = 1
    else:
        if not Fau:
            Fau = Fq
            audiodecim = 1
        else:
            audiodecim = int(np.floor(Fq / Fau + 0.5))
            if abs(Fau * audiodecim - Fq) > 0.5:
                raise ValueError("Audio decimation ratio must be integer")
    return Fq, Fau, audiodecim


def channel_weights(cfg: MlmConfig, Fq: float):
    """Per-channel bin index, 2x2x2 combining weights and derotation
    (leanmlmrx.cc:575-625)."""
    N = cfg.N
    stride = int(np.floor(cfg.Fs / Fq + 0.5))
    if stride < N:
        raise ValueError("FFT windows overlap")
    ibins, weights, derots = [], [], []
    for ch in cfg.channels:
        fbin = N * (ch.F - cfg.Fc) / cfg.Fs
        b = int(np.floor(fbin))
        frel = fbin - b
        if frel < 0.125:
            bw = [[[1, 0], [0, 1]], [[0, 0], [0, 0]]]
        elif frel < 0.375:
            bw = [[[0.707, 0.707], [-0.070, 0.707]],
                  [[-0.2, -0.2], [0.2, -0.2]]]
        elif frel < 0.625:
            bw = [[[0, 1], [-1, 0]], [[0, -1], [1, 0]]]
        elif frel < 0.875:
            bw = [[[-0.2, 0.2], [-0.2, -0.2]],
                  [[0.707, -0.707], [0.707, 0.707]]]
        else:
            bw = [[[0, 0], [0, 0]], [[1, 0], [0, 1]]]
        bw = np.array(bw, np.float32) * np.float32(8.0 * 128 / 2048 / N)
        ibins.append((N + b) % N)
        weights.append(bw)
        derot = 2 * np.pi * (ch.F - cfg.Fc) * stride / cfg.Fs
        derot = (derot + np.pi) % (2 * np.pi) - np.pi
        derots.append(np.int16(int(derot * 65536 / (2 * np.pi))))
    return (np.array(ibins), np.stack(weights) if weights else
            np.zeros((0, 2, 2, 2), np.float32),
            np.array(derots, np.int16), stride)


def _atan2_u16(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lut_atan2 semantics (leanmlmrx.cc:203-208): s8-quantized atan2 as
    u16 angle; inputs already halved into [-126,126] and truncated."""
    a = atan2_poly(y, x)
    return torch.trunc(a * _U16_PER_RAD).to(torch.int32) & 0xFFFF


def channelize_pre(xr: torch.Tensor, xi: torch.Tensor, ibins: torch.Tensor,
                   weights: torch.Tensor):
    """[nframes, N] float32 window planes -> the combined bins (d_re,
    d_im) [nframes, nchan] after the overflow halving, before the trunc."""
    N = xr.shape[1]
    br, bi = fft_planes(xr, xi, N)                 # FFTW sign -1
    b0r, b0i = br[:, ibins], bi[:, ibins]          # [F, C]
    i1 = (ibins + 1) % N
    b1r, b1i = br[:, i1], bi[:, i1]
    w = weights
    # d[i] = sum_b bw[b,i,0]*re_b + bw[b,i,1]*im_b, in JAX's order.
    d_re = (w[None, :, 0, 0, 0] * b0r + w[None, :, 0, 0, 1] * b0i
            + w[None, :, 1, 0, 0] * b1r + w[None, :, 1, 0, 1] * b1i)
    d_im = (w[None, :, 0, 1, 0] * b0r + w[None, :, 0, 1, 1] * b0i
            + w[None, :, 1, 1, 0] * b1r + w[None, :, 1, 1, 1] * b1i)
    for _ in range(10):
        over = ((d_re < -126) | (d_re > 126)
                | (d_im < -126) | (d_im > 126))
        d_re = torch.where(over, d_re * 0.5, d_re)
        d_im = torch.where(over, d_im * 0.5, d_im)
    return d_re, d_im


def channelize(xr: torch.Tensor, xi: torch.Tensor, ibins: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """[nframes, N] float32 window planes -> [nframes, nchan] u16 phases
    (int32), on the planes' device."""
    d_re, d_im = channelize_pre(xr, xi, ibins, weights)
    return _atan2_u16(torch.trunc(d_im), torch.trunc(d_re))


class MlmReceiver:
    """Streaming multi-channel FM demodulator; its stages on `device`
    (default CUDA), the sample backlog and the audio out on the host."""

    def __init__(self, cfg: MlmConfig, device=None):
        self.cfg = cfg
        self.device = _dev.resolve_device(device)
        self.Fq, self.Fau, self.audiodecim = resolve_rates(cfg)
        self.ibins, self.weights, self.derots, self.stride = \
            channel_weights(cfg, self.Fq)
        self.nchan = len(cfg.channels)
        self.enabled = np.array([c.enabled for c in cfg.channels], bool)
        dev = self.device
        self._ibins = torch.from_numpy(self.ibins.astype(np.int64)).to(dev)
        self._weights = torch.from_numpy(self.weights).to(dev)
        self._derots = torch.from_numpy(self.derots.astype(np.int32)).to(dev)
        self.prevph = torch.zeros(self.nchan, dtype=torch.int32, device=dev)
        self.rms = torch.ones(self.nchan, dtype=torch.float32, device=dev)
        self.deemph_state = 0.0
        self.audioclock = 0
        self.backlog = np.empty(0, np.complex64)
        self.alpha_deemph = 1 / (self.Fq * cfg.deemph)
        self.alpha_squelch = 1 / (self.Fau * 0.1)
        self.discr_gain = (self.Fq / 65536 / (2 * cfg.maxdev)) * 0.75 * 256

    def _windows(self, nframes: int):
        """The next nframes windows as [nframes, N] (re, im) planes on
        the device: one copy of the samples they span, read through a
        strided view."""
        N = self.cfg.N
        span = (nframes - 1) * self.stride + N
        x = torch.from_numpy(self.backlog[:span].view(np.float32).reshape(
            span, 2)).to(self.device)
        w = x.unfold(0, N, self.stride)             # [F, 2, N]
        return w[:, 0], w[:, 1]

    def process(self, iq: np.ndarray) -> np.ndarray:
        """[n] complex64 -> int8 audio samples."""
        cfg = self.cfg
        self.backlog = np.concatenate([self.backlog,
                                       np.asarray(iq, np.complex64)])
        nframes = max(0, (len(self.backlog) - cfg.N) // self.stride + 1)
        if nframes == 0 or self.nchan == 0:
            return np.empty(0, np.int8)
        xr, xi = self._windows(nframes)
        self.backlog = self.backlog[nframes * self.stride:]
        ph = channelize(xr, xi, self._ibins, self._weights)   # [F, C]

        # FM discriminator: dph = ph - prevph - derot (u16 -> s16)
        prev = torch.cat([self.prevph[None, :], ph[:-1]])
        dph = ph - prev - self._derots[None, :]
        dph = ((dph & 0xFFFF) ^ 0x8000) - 0x8000
        self.prevph = ph[-1]

        dev = dph.to(torch.float32)
        active = torch.from_numpy(self.enabled).to(self.device)[None, :] \
            .expand(dev.shape)
        if cfg.squelch:
            # Per-channel RMS EMA gate (leanmlmrx.cc:701-705), first-order
            # recurrence via associative scan.
            r = _first_order_scan(dev * dev / float(np.float32(32768.0 ** 2)),
                                  self.rms, self.alpha_squelch)
            self.rms = r[-1]
            active = active & (r <= float(np.float32(1 - cfg.squelch)))
        # The sum of at most 201 integers below 2^15: exact in float32 in
        # any order.
        audio = torch.where(active, dev, 0.0).sum(1)
        nactive = active.sum(1)

        # De-emphasis one-pole over frames (leanmlmrx.cc:710-711).
        out = _first_order_scan(audio, float(np.float32(self.deemph_state)),
                                self.alpha_deemph)
        self.deemph_state = float(out[-1])

        # The mixdown scale in float64, as JAX's NumPy stage computes it.
        nf = torch.clamp(nactive, min=1).to(torch.float64)
        inv = torch.ones_like(nf) / torch.sqrt(nf)
        scale = torch.where(nactive > 0, inv, 0.0)
        samples = out.to(torch.float64) * scale \
            * float(np.float32(self.discr_gain))

        if self.audiodecim < 0:
            au = torch.repeat_interleave(samples, -self.audiodecim)
        else:
            # Emit every audiodecim-th frame, phase carried in audioclock.
            first = (-(self.audioclock + 1)) % self.audiodecim
            self.audioclock = (self.audioclock + len(samples)) \
                % self.audiodecim
            au = samples[first::self.audiodecim]
        au8 = (torch.trunc(au).to(torch.int64) & 0xFF).to(torch.uint8)
        if cfg.wav:
            au8 ^= 128
        return au8.cpu().numpy().view(np.int8)
