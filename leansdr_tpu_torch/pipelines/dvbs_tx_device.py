"""Device-side DVB-S modulator: the whole TX chain as torch ops on the
card (the counterpart of leansdr_tpu/pipelines/dvbs_tx_device.py).

Every stage of leandvbtx (randomizer -> RS(204,188) -> interleaver ->
convolutional encoder -> mapper -> RRC interpolation) is GF(2)-linear or
a gather, so the chain runs on the device end to end:

  randomize    XOR with the precomputed 188*8 pattern
  RS encode    fec/rs.torch_encode: one float32 matmul of 0/1 planes,
               mod 2 (the sums are at most 1504, exact in float32, with
               TF32 off)
  interleave   static gather over a 12-packet window
  convolve     XOR of statically-shifted bit lanes (the puncturing is in
               the shifted-polynomial taps, like the host encoder)
  map          constellation gather -> (re, im) planes
  RRC          polyphase taps as `interp` streaming FIRs, summed as the
               JAX chain sums them (acc + c * x, taps in order), so the
               CPU and the card give the same bits

The JAX chain is plain XLA (no Pallas kernel), and so is this one: torch
ops, no kernel of its own. Batch axis = packets. The host
`dvbs_tx.modulate` remains the behavioral reference (bit-exact vs the
C++ binary); this path is validated against it after the RRC latency.
"""

from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from ..dsp import filtergen
from ..dsp.cstln import CSTLN_AMP, Predef, make_dvbs2_constellation
from ..fec import convenc, interleave, prbs, rs


@lru_cache(maxsize=None)
def _conv_taps(rate: str):
    """For each output bit position p: input-bit offsets (relative to the
    emitting input-bit index i_t) whose XOR gives the coded bit."""
    polys = convenc.POLYS[rate]
    H = convenc.HISTSIZE
    return tuple(
        tuple(j - (H - 1) for j in range(H) if (poly >> j) & 1)
        for poly in polys)


def _unpack_bits(b: torch.Tensor) -> torch.Tensor:
    """[..., m] uint8 -> [..., 8m] uint8 bits, MSB first."""
    k = torch.arange(7, -1, -1, device=b.device, dtype=torch.int32)
    bits = (b.to(torch.int32)[..., None] >> k) & 1
    return bits.reshape(*b.shape[:-1], -1).to(torch.uint8)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8m] uint8 bits -> [..., m] uint8, MSB first."""
    k = torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    return (b << k).sum(-1).to(torch.uint8)


class DeviceModulator:
    """TX for a fixed (constellation, rate, interp) config on `device`
    (default CUDA; "cpu" runs the same torch ops on the host)."""

    def __init__(self, constellation=Predef.QPSK, rate="1/2",
                 amp=1.0, interp=2, rolloff=0.35, rrc_rej=10.0,
                 device=None):
        self.device = _dev.resolve_device(device)
        cstln = make_dvbs2_constellation(constellation, rate)
        if rate == "2/3" and cstln.nsymbols in (4, 64):
            rate = "4/6"
        self.rate = rate
        self.bps = cstln.bits_per_symbol
        self.interp = interp

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.pat = t(prbs.prbs_pattern().reshape(8, 188))
        self.ilv_idx = t(interleave.interleave_indices().astype(np.int64))
        self.sym_pts = t(cstln.symbols.astype(np.float32))
        order = int(interp * rrc_rej)
        coeffs = filtergen.normalize_power(
            filtergen.root_raised_cosine(order, 1.0 / interp, rolloff),
            amp / CSTLN_AMP)
        self.ncoeffs = len(coeffs)
        # Polyphase split: output sample p*interp+i uses coeffs[i::interp]
        # on symbols p, p-1, ... — pad branches to a common length.
        branches = [coeffs[i::interp] for i in range(interp)]
        npoly = max(len(b) for b in branches)
        self.rrc = t(np.stack([np.pad(b, (0, npoly - len(b)))
                               for b in branches]).astype(np.float32))

    def symbols(self, packets: torch.Tensor) -> torch.Tensor:
        """[n, 188] uint8 TS on the device -> the constellation symbols
        [nsym] int32 there (randomizer to convolutional encoder)."""
        dev = self.device
        n = packets.shape[0]
        if n < 12:
            raise ValueError(f"{n} packets: the interleaver needs 12")
        # --- randomizer: XOR with the 8-packet PRBS pattern ---
        rand = packets ^ self.pat[torch.arange(n, device=dev) % 8]
        # --- RS encode: GF(2) matmul of message bits ---
        bits = _unpack_bits(rand)                       # [n, 1504]
        par_bits = rs.torch_encode(bits)
        rspackets = _pack_bits(torch.cat([bits, par_bits], 1))  # [n, 204]
        # --- interleaver: gather over 12-packet windows ---
        flat = rspackets.reshape(-1)
        base = (torch.arange(n - 11, device=dev)[:, None] * 204
                + self.ilv_idx[None, :])
        ilv = flat[base].reshape(-1)                    # [(n-11)*204]
        # --- convolutional encoder: XOR of shifted bit lanes ---
        bits_in, _ = convenc.FEC_SPECS[self.rate]
        dbits = _unpack_bits(ilv[: ilv.shape[0] // bits_in * bits_in])
        H = convenc.HISTSIZE
        ext = torch.cat([torch.zeros(H - 1, dtype=torch.uint8, device=dev),
                         dbits])
        ngroups = dbits.shape[0] // bits_in
        i_t = (torch.arange(ngroups, device=dev) + 1) * bits_in - 1
        outb = []
        for tap in _conv_taps(self.rate):
            acc_b = torch.zeros(ngroups, dtype=torch.uint8, device=dev)
            for off in tap:
                acc_b = acc_b ^ ext[i_t + off + (H - 1)]
            outb.append(acc_b)
        stream = torch.stack(outb, 1).reshape(-1, self.bps).to(torch.int32)
        w = 1 << torch.arange(self.bps - 1, -1, -1, device=dev,
                              dtype=torch.int32)
        return (stream * w).sum(1, dtype=torch.int32)

    def modulate_tensor(self, packets: torch.Tensor) -> torch.Tensor:
        """[n, 188] uint8 TS on the device -> [m, 2] float32 IQ there."""
        dev = self.device
        # --- mapper ---
        iq = self.sym_pts[self.symbols(packets)]        # [nsym, 2]
        # --- RRC interpolation: polyphase = interp FIRs over the symbols
        nsym = iq.shape[0]
        npoly = self.rrc.shape[1]
        ext_iq = torch.cat([torch.zeros((npoly - 1, 2), dtype=torch.float32,
                                        device=dev), iq])
        phases_out = []
        for i in range(self.interp):
            taps_i = self.rrc[i]
            acc_iq = torch.zeros((nsym, 2), dtype=torch.float32, device=dev)
            for j in range(npoly):
                acc_iq = acc_iq + taps_i[j] * ext_iq[npoly - 1 - j:
                                                     npoly - 1 - j + nsym]
            phases_out.append(acc_iq)
        return torch.stack(phases_out, 1).reshape(nsym * self.interp, 2)

    def modulate(self, packets: np.ndarray) -> np.ndarray:
        """[n,188] uint8 TS -> [m,2] float32 IQ (device computed)."""
        pk = torch.from_numpy(np.ascontiguousarray(packets, np.uint8))
        return self.modulate_tensor(pk.to(self.device)).cpu().numpy()


def device_stimulus(pkts, rate: str = "1/2", interp: int = 2,
                    amp: float = 75.0, device=None) -> torch.Tensor:
    """TS packets -> DEVICE-resident float32 IQ [m, 2] (bench helper).

    Modulates on the device without the host round trip of
    DeviceModulator.modulate. A device chain that fails raises: there is
    no fallback to host modulation, so no benchmark ingest can include a
    host link transfer unannounced."""
    mod = DeviceModulator(rate=rate, interp=interp, amp=amp, device=device)
    pk = torch.as_tensor(np.ascontiguousarray(pkts, np.uint8))
    y = mod.modulate_tensor(pk.to(mod.device))
    if y.device.type == "cuda":
        torch.cuda.synchronize(y.device)
    return y
