"""Batched multi-candidate acquisition scan (the counterpart of
leansdr_tpu/pipelines/scan_rx.py).

The reference's leansdrscan (leansdrscan.cc:62-205) fork/execs one
demodulator config at a time, feeds it the stream, and elects the first
config that PRODUCES OUTPUT within a timeout (run_program returns
nreceived; any nonzero wins, leansdrscan.cc:187-199). Here ALL candidate
(symbol rate, code rate) hypotheses race concurrently on the device:
distinct symbol rates ride the channel axis of one scan-demod launch
(dsp/receiver.run_chunks with per-channel omega: csrc/scan_demod.cu
loads each channel's omega, freq_beta and freq limits from a [5, C]
plane), each (SR, CR) candidate gets its own host byte-domain chain
(multi_rx._ByteChain) fed from its symbol-rate group, and the election
is the same output-production rule — first candidate (in grid order)
whose chain emits TS packets.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _dev
from ..dsp import receiver
from ..dsp.cstln import Predef, make_dvbs2_constellation
from .dvbs_rx import TS_SIZE
from .multi_rx import _ByteChain


@dataclass
class Candidate:
    Fm: float
    rate: str


class CandidateScanReceiver:
    """Demodulate all candidates concurrently; elect by output. The demod
    runs on `device` (default CUDA), the byte chains on the host."""

    def __init__(self, Fs: float, candidates, float_scale: float = 1.0,
                 constellation: Predef = Predef.QPSK, device=None):
        self.device = _dev.resolve_device(device)
        self.Fs = Fs
        self.candidates = list(candidates)
        self.float_scale = float_scale
        cstln = make_dvbs2_constellation(constellation,
                                         self.candidates[0].rate)
        self.cstln = cstln

        # One demod channel per DISTINCT symbol rate; code-rate
        # candidates fan out of the same symbol stream (the demod is
        # rate-agnostic for a fixed constellation).
        fms = []
        for c in self.candidates:
            if c.Fm not in fms:
                fms.append(c.Fm)
        self.group_fms = fms
        self.group_of = [fms.index(c.Fm) for c in self.candidates]
        G = len(fms)
        omegas = np.array([Fs / fm for fm in fms], np.float32)
        self.params = receiver.ReceiverParams(
            omega=float(omegas.mean()),
            sampler="linear",
            nsymbols=cstln.nsymbols,
            exact_lut=False,
            omega_per_channel=True,
        )
        self.state = receiver.init_state(self.params, G, self.device)
        self.state.update(receiver.per_channel_omega_state(
            self.params, omegas, self.device))
        self.tables = receiver.make_tables(cstln, self.device)
        self.chains = [
            _ByteChain("4/6" if c.rate == "2/3" else c.rate, fastlock=True)
            for c in self.candidates]
        self.outputs = [np.empty((0, TS_SIZE), np.uint8)
                        for _ in self.candidates]
        self.sample_backlog = np.empty((0, 2), np.float32)
        self._winner = None

    @classmethod
    def grid(cls, Fs: float, symbol_rates, rates, **kw):
        """Cartesian sweep, e.g. 4 SR x 5 CR (the reference's
        'leansdrscan leandvb --sr a,b,c,d --cr 1/2,2/3,3/4,5/6,7/8')."""
        cands = [Candidate(Fm=float(sr), rate=r)
                 for sr in symbol_rates for r in rates]
        return cls(Fs, cands, **kw)

    def process(self, iq: np.ndarray):
        """Feed [n,2] IQ shared by all candidates; returns winner index
        (or None) — decoded TS accumulates in self.outputs[i]."""
        iq = np.asarray(iq, np.float32) * np.float32(self.float_scale)
        self.sample_backlog = np.concatenate([self.sample_backlog, iq])
        ra = self.params.readahead
        K = (len(self.sample_backlog) - ra) // receiver.CHUNK
        if K <= 0:
            return self.winner()
        n = K * receiver.CHUNK
        x = self.sample_backlog[: n + ra]
        self.sample_backlog = self.sample_backlog[n:]
        G = len(self.group_fms)
        # Every group reads the same samples: one copy to the device,
        # expanded (not copied) over the channel axis.
        xb = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.state, out = receiver.run_chunks(
            self.params, self.tables, self.state, xb[None].expand(G, -1, -1))
        sym = out["symbol"].cpu().numpy()
        valid = out["valid"].cpu().numpy()
        syms = [sym[g][valid[g]] for g in range(G)]
        for c, g in enumerate(self.group_of):
            ts = self.chains[c].feed(syms[g])
            if len(ts):
                self.outputs[c] = np.concatenate([self.outputs[c], ts])
        return self.winner()

    def winner(self):
        """Output-production election (leansdrscan.cc:187: 'if
        (nreceived)' => success): first candidate in grid order with
        decoded TS output, sticky once elected."""
        if self._winner is None:
            for c, out in enumerate(self.outputs):
                if len(out):
                    self._winner = c
                    break
        return self._winner

    def focus(self, c: int) -> None:
        """Drop every candidate but `c` and keep streaming: the demod
        batch shrinks to the winner's symbol-rate group and only its
        byte chain stays live. This is the live-mode handoff: the locked
        receiver keeps the SAME loop state (every state entry, the
        per-channel omega ones included) and backlog, so no signal is
        lost and no process restarts at lock."""
        g = self.group_of[c]
        self.state = {k: v[g:g + 1] for k, v in self.state.items()}
        self.group_fms = [self.group_fms[g]]
        self.candidates = [self.candidates[c]]
        self.group_of = [0]
        self.chains = [self.chains[c]]
        self.outputs = [self.outputs[c]]
        self._winner = 0
