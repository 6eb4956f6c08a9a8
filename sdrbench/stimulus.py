"""The benchmark's own DVB-S test signal, built from the seed.

A frozen copy of the DVB-S transmit chain (ETSI EN 300 421, in the
arithmetic of leansdr's leandvbtx) and of a channel:

  numbered TS packets -> energy-dispersal randomizer -> RS(204,188)
  -> Forney interleaver (I=12, M=17) -> convolutional code (K=7, G1=0171,
  G2=0133, rate 1/2) -> QPSK -> RRC interpolation (rolloff 0.35, 2
  samples per symbol) -> fractional delay, carrier offset, AWGN
  [-> a birdie and u8 quantisation]

The capture is circular. It holds `npkt` packets per carrier (a multiple
of 8, the randomizer's period), and every stage runs around the loop: the
interleaver takes packets modulo npkt, the encoder's history wraps, the
RRC filter and the fractional delay are circular convolutions, and each
carrier offset is rounded to a whole number of turns per loop. So a
receiver that reads the capture again and again (as `leandvb --loop`
reads a file) sees one unbroken signal.

Nothing here imports the program: the byte and bit stages are NumPy or
torch integer arithmetic, the signal stages torch float32 on the device
the caller names (the card in a run, the CPU in the tests).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

TS_SIZE = 188
RS_SIZE = 204
INTERLEAVE = 12
CSTLN_AMP = 75.0
QPSK_AMP = 53.0                 # the QPSK points of leansdr's cstln (75/sqrt 2)
G1, G2 = 0o171, 0o133
HISTSIZE = 16                   # the encoder's register (convolutional.h)
INTERP = 2                      # samples per symbol
RRC_REJ = 10.0                  # leandvbtx's default filter order factor
ROLLOFF = 0.35
# The integer sample formats: range, the offset of zero, the type.
INT_FORMATS = {"u8": (0, 255, 128.0, torch.uint8),
               "s16": (-32768, 32767, 0.0, torch.int16)}


# ------------------------------------------------------------- byte stages

def ts_packets(nchan: int, npkt: int) -> np.ndarray:
    """[C, npkt, 188] numbered packets (leantsgen's layout: 4-byte groups
    of {offset, 24-bit number}, byte 0 the 0x47 sync). Carrier c's packet
    k carries the number c * npkt + k."""
    n = (np.arange(nchan)[:, None] * npkt + np.arange(npkt)[None, :])[..., None]
    pkt = np.zeros((nchan, npkt, TS_SIZE), np.uint8)
    i = np.arange(0, TS_SIZE - 3, 4)
    pkt[..., i] = i.astype(np.uint8)
    pkt[..., i + 1] = (n >> 16) & 0xFF
    pkt[..., i + 2] = (n >> 8) & 0xFF
    pkt[..., i + 3] = n & 0xFF
    pkt[..., 0] = 0x47
    return pkt


@lru_cache(maxsize=None)
def prbs_pattern() -> np.ndarray:
    """The randomizer's 8-packet pattern (EN 300 421 4.4.1: 1+x^14+x^15
    seeded 100101010000000; the first sync byte inverted, the other seven
    left as they are while the generator runs on)."""
    pat = np.zeros(TS_SIZE * 8, np.uint8)
    pat[0] = 0xFF
    st = 0o000251
    for i in range(1, TS_SIZE * 8):
        out = 0
        for _ in range(8):
            bit = ((st >> 13) ^ (st >> 14)) & 1
            out = ((out << 1) | bit) & 0xFF
            st = ((st << 1) | bit) & 0xFFFF
        pat[i] = out if i % TS_SIZE else 0
    return pat


@lru_cache(maxsize=None)
def _gf_tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    a = 1
    for i in range(255):
        exp[i] = exp[255 + i] = a
        log[a] = i
        a <<= 1
        if a & 0x100:
            a ^= 0x11D                   # x^8 + x^4 + x^3 + x^2 + 1
    return exp, log


def _gf_mul(x, y):
    exp, log = _gf_tables()
    x, y = np.asarray(x, np.int64), np.asarray(y, np.int64)
    return np.where((x == 0) | (y == 0), 0, exp[log[x] + log[y]])


@lru_cache(maxsize=None)
def rs_product_table() -> np.ndarray:
    """[256, 17] uint8: a * G for every byte a, G the RS(204,188)
    generator prod_{d<16} (x - alpha^d), highest power first."""
    exp, _ = _gf_tables()
    g = np.zeros(17, np.int64)
    g[16] = 1
    for d in range(16):
        g = np.concatenate([g[1:], [0]]) ^ _gf_mul(exp[d], g)
    return _gf_mul(np.arange(256)[:, None], g[None, :]).astype(np.uint8)


def rs_encode(msgs: torch.Tensor) -> torch.Tensor:
    """[n, 188] uint8 -> [n, 204]: systematic RS(204,188) (the shortened
    RS(255,239) of EN 300 421 4.4.2), by long division in GF(256)."""
    mul = torch.from_numpy(rs_product_table()).to(msgs.device)
    p = torch.zeros((msgs.shape[0], RS_SIZE), dtype=torch.uint8,
                    device=msgs.device)
    p[:, :TS_SIZE] = msgs
    for d in range(TS_SIZE):
        p[:, d:d + 17] ^= mul[p[:, d].long()]
    return torch.cat([msgs, p[:, TS_SIZE:]], dim=1)


def interleave_circular(rs: torch.Tensor) -> torch.Tensor:
    """[C, npkt, 204] -> [C, npkt * 204] bytes out of the Forney
    interleaver in steady state around the loop: output packet k's byte
    i is packet (k + 11 - i % 12) mod npkt's byte i (dvb.h:906-916)."""
    C, npkt, _ = rs.shape
    i = torch.arange(RS_SIZE, device=rs.device)
    k = torch.arange(npkt, device=rs.device)[:, None]
    src = (k + (INTERLEAVE - 1) - i % INTERLEAVE) % npkt      # [npkt, 204]
    out = rs[:, src, i[None, :].expand(npkt, RS_SIZE)]
    return out.reshape(C, -1)


def packet_end_bytes(npkt: int) -> np.ndarray:
    """[npkt] the index (in the interleaved stream) of the last byte that
    carries part of packet k: its byte 203, which leaves in output packet
    k itself (203 % 12 == 11)."""
    return np.arange(npkt) * RS_SIZE + RS_SIZE - 1


# ------------------------------------------------------------ bit stages

def encode_circular(stream: torch.Tensor) -> torch.Tensor:
    """[C, nbytes] uint8 -> [C, nbytes * 8] QPSK symbols (0..3) of the
    rate-1/2 code around the loop. As leansdr's convol_multipoly, each
    input bit enters bit 15 of a 16-bit register shifting right, and the
    output pair is parity(reg & G1), parity(reg & G2), G1 first (the
    symbol's high bit)."""
    shifts = torch.arange(7, -1, -1, device=stream.device, dtype=torch.uint8)
    bits = ((stream[..., None] >> shifts) & 1).reshape(stream.shape[0], -1)

    def parity(poly):
        acc = torch.zeros_like(bits)
        for j in range(HISTSIZE):
            if (poly >> j) & 1:
                # register bit j holds the bit HISTSIZE-1-j steps back
                acc ^= torch.roll(bits, HISTSIZE - 1 - j, dims=1)
        return acc

    return parity(G1) * 2 + parity(G2)


def packet_end_samples(npkt: int) -> np.ndarray:
    """[npkt] the sample (exclusive end, from the capture's start) after
    the last one that carries part of packet k: its last interleaved bit
    reaches the encoder's outputs for HISTSIZE-1 more bits, each one QPSK
    symbol of INTERP samples, then the RRC filter's length and the
    fractional delay's one sample."""
    last_bit = (packet_end_bytes(npkt) + 1) * 8 - 1
    return (last_bit + HISTSIZE) * INTERP + len(rrc_taps()) + 1


# ---------------------------------------------------------- signal stages

def rrc_taps() -> np.ndarray:
    """leandvbtx's interpolation filter: filtergen.h's closed-form RRC of
    order INTERP * RRC_REJ at Fm/Fs = 1/INTERP, DC-normalised, then scaled
    to power (1 / CSTLN_AMP)^2 (float32 throughout)."""
    B = ROLLOFF
    fs = 1.0 / INTERP
    ncoeffs = (int(INTERP * RRC_REJ) + 1) | 1
    t = np.arange(ncoeffs, dtype=np.float64) - ncoeffs // 2
    tT = t * fs
    den = np.pi * tT * (1 - (4 * B * tT) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        general = np.sqrt(fs) * (np.sin(np.pi * tT * (1 - B))
                                 + 4 * B * tT * np.cos(np.pi * tT * (1 + B))
                                 ) / den
    singular = B * np.sqrt(fs / 2) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * B))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * B)))
    c = np.where(den == 0, singular, general)
    c[t == 0] = np.sqrt(fs) * (1 - B + 4 * B / np.pi)
    c = c.astype(np.float32)
    c = (c * np.float32(1.0 / float(np.sum(c.astype(np.float64))))
         ).astype(np.float32)
    s2 = float(np.sum(c.astype(np.float64) ** 2))
    return (c * np.float32((1.0 / CSTLN_AMP) / np.sqrt(s2))).astype(np.float32)


def _circular_fir(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """y[t] = sum_k taps[k] x[t - k] around the last axis but one."""
    y = torch.zeros_like(x)
    for k, c in enumerate(taps):
        y += float(c) * torch.roll(x, k, dims=-2)
    return y


@dataclass
class Capture:
    """A circular capture and what the checks need to know of it."""
    iq: torch.Tensor             # [C, L + extra, 2] float32, uint8 or int16
    period: int                  # L, samples per loop
    npkt: int                    # packets per carrier per loop
    packets: np.ndarray          # [C, npkt, 188] the packets sent
    stream: np.ndarray           # [C, npkt * 204] the interleaved bytes
    end_sample: np.ndarray       # [npkt] packet k's end sample in a loop


def loop_turns(hz_or_cycles, period: int) -> np.ndarray:
    """Frequencies in cycles/sample rounded to whole turns per loop:
    returns the integer turns m, so the tone is m / period cycles/sample
    and continues unbroken across the loop point."""
    return np.round(np.asarray(hz_or_cycles, np.float64) * period
                    ).astype(np.int64)


def _tones(m: torch.Tensor, period: int, dev) -> tuple:
    """cos and sin [len(m), period] float32 of m turns per loop."""
    t = torch.arange(period, device=dev, dtype=torch.int64)
    ph = ((m[:, None] * t[None, :]) % period).to(torch.float64) * (
        2 * np.pi / period)
    return ph.cos().float(), ph.sin().float()


def _resample_circular(x: torch.Tensor, up: int, down: int,
                       phase: int) -> torch.Tensor:
    """[C, L, 2] -> [C, L * up / down, 2]: band-limited interpolation by
    `up` around the loop (zero-padded spectrum), then every `down`-th
    sample from `phase` (chip_smoke's resample_poly(z, up, 1)[phase::down],
    with the ideal filter)."""
    C, L, _ = x.shape
    if (L * up) % down:
        raise ValueError(f"{L} samples x {up} / {down} is not whole")
    z = torch.complex(x[..., 0].double(), x[..., 1].double())
    f = torch.fft.fft(z, dim=1)
    h = L // 2
    F = torch.zeros((C, L * up), dtype=f.dtype, device=x.device)
    F[:, :h] = f[:, :h]
    F[:, L * up - (L - h):] = f[:, h:]
    y = torch.fft.ifft(F, dim=1)[:, phase::down] * up
    return torch.stack([y.real.float(), y.imag.float()], -1)


def make_capture(traffic: dict, seed: int, device, extra: int = 0,
                 float_scale: float = 1.0) -> Capture:
    """The capture of a traffic mix on `device`, with `extra` samples of
    the loop's start appended, so that any window of up to `extra`
    samples read from an offset inside the first loop lies in the tensor
    whole. The seed draws each carrier's fractional delay and the noise;
    the packets are the same for every seed.

    Keys of the mix: `carriers`, `packets_per_loop`, `esn0_db`; the
    carrier offsets, either `offset_center` and `offset_step` (carrier c
    at (c - center) * step cycles/sample) or `offset_hz` at `fs`;
    `fractional_delay` (each carrier delayed by a uniform fraction of a
    sample, default on); `resample` [up, down, phase] from 2 samples per
    symbol; the noise sets Es/N0 to `esn0_db` at the output's samples
    per symbol; `birdie_hz` (a tone `birdie_db` below the signal's
    power); `format`: "f32" (times float_scale), or "u8" or "s16" (a
    front end's integers: the signal scaled to `rms` per component,
    rounded, offset by 128 for u8, saturated)."""
    C = int(traffic["carriers"])
    npkt = int(traffic["packets_per_loop"])
    if npkt % 8:
        raise ValueError("packets_per_loop must be a multiple of 8")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    pkts = ts_packets(C, npkt)
    rand = pkts ^ prbs_pattern().reshape(8, TS_SIZE)[np.arange(npkt) % 8]
    rs = rs_encode(torch.from_numpy(rand.reshape(-1, TS_SIZE)).to(dev))
    stream = interleave_circular(rs.reshape(C, npkt, RS_SIZE))
    sym = encode_circular(stream)                       # [C, L / INTERP]
    L = sym.shape[1] * INTERP
    # QPSK: symbol bit 1 = I negative, bit 0 = Q negative.
    up = torch.zeros((C, L, 2), dtype=torch.float32, device=dev)
    up[:, ::INTERP, 0] = QPSK_AMP * (1 - 2 * (sym >> 1).float())
    up[:, ::INTERP, 1] = QPSK_AMP * (1 - 2 * (sym & 1).float())
    del sym
    x = _circular_fir(up, rrc_taps())
    del up
    sps = float(INTERP)
    ends = packet_end_samples(npkt)
    if traffic.get("fractional_delay", True):
        d = torch.rand((C, 1, 1), device=dev, generator=gen)
        x = (1 - d) * x + d * torch.roll(x, -1, dims=1)
    if traffic.get("resample"):
        r_up, r_down, r_phase = traffic["resample"]
        x = _resample_circular(x, r_up, r_down, r_phase)
        L = x.shape[1]
        sps = sps * r_up / r_down
        ends = -((-ends * r_up) // r_down)
    ps = float(x.square().sum(-1).mean())
    if "offset_hz" in traffic:
        cyc = np.full(C, traffic["offset_hz"] / traffic["fs"])
    else:
        cyc = (np.arange(C) - traffic["offset_center"]) * traffic["offset_step"]
    cr, sr = _tones(torch.from_numpy(loop_turns(cyc, L)).to(dev), L, dev)
    xr, xi = x[..., 0], x[..., 1]
    x = torch.stack([xr * cr - xi * sr, xr * sr + xi * cr], -1)
    del xr, xi, cr, sr
    esn0 = 10 ** (float(traffic["esn0_db"]) / 10)
    sigma = np.sqrt(ps * sps / esn0 / 2)
    x += sigma * torch.randn(x.shape, device=dev, generator=gen)
    if traffic.get("birdie_hz"):
        m = loop_turns([traffic["birdie_hz"] / traffic["fs"]], L)
        cb, sb = _tones(torch.from_numpy(m).to(dev), L, dev)
        a = np.sqrt(ps * 10 ** (-traffic.get("birdie_db", 20.0) / 10))
        x[..., 0] += a * cb
        x[..., 1] += a * sb
    fmt = traffic.get("format", "f32")
    if fmt in INT_FORMATS:
        lo, hi, zero, dtype = INT_FORMATS[fmt]
        x = x * (traffic["rms"] / float(x.square().mean().sqrt()))
        x = torch.clamp(torch.round(x) + zero, lo, hi).to(dtype)
    elif fmt == "f32":
        x = x * float_scale
    else:
        raise ValueError(f"format {fmt!r}")
    if extra:
        x = torch.cat([x, x[:, :extra]], dim=1)
    return Capture(iq=x.contiguous(), period=L, npkt=npkt, packets=pkts,
                   stream=stream.cpu().numpy(), end_sample=ends)
