"""Driver of the single-carrier DVB-S receiver (leansdr_tpu_torch's
`pipelines/dvbs_rx.DvbsReceiver.process()`), fed as `apps/leandvb.py`
feeds it: reads of `read_samples` samples of the capture's bytes, each
decoded by the program's `util/iofmt.read_iq` in the traffic's `format`.

Set-up builds the capture (its bytes on the host, as a file or a front
end's pipe gives them) and the receiver, and drives it through its first
`warmup_inputs` reads with the same call the window makes: past lock and
past the auto-notch's first detection (its first FFT). The window then
reads on, looping the capture, at the traffic's pace.
"""

import time

import numpy as np
import torch

from sdrbench import check, reference, stimulus
from sdrbench.check import compare_soft
from sdrbench.harness import StreamDriver


def _program():
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_tpu_torch.util.iofmt import read_iq
    return dict(rk=rk, Predef=Predef, DvbsReceiver=DvbsReceiver,
                RxConfig=RxConfig, read_iq=read_iq)


class Driver(StreamDriver):
    """One run of a single-carrier cell (harness.StreamDriver)."""

    FAULTS = ("state", "ts", "dec", "sym")

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        super().__init__(config, traffic, seed, device, trace)
        self.nchan = 1
        self.step = self.R = int(config["read_samples"])
        self.format = traffic["format"]
        self._soft_cache = {}

    def plant(self, fault: str):
        """Break the timed path for the fault test (before setup()):
        "state", the demod hands its input state on unchanged; "ts", one
        byte of the first TS packet of each read is altered; "dec", one
        bit of each block the hard decoder gives out is flipped; "sym",
        every 97th emitted symbol is relabelled."""
        super().plant(fault)

    # ------------------------------------------------------------ set-up

    def setup(self):
        p = _program()
        rc = dict(self.cfg["receiver"])
        rc["constellation"] = p["Predef"][rc["constellation"]]
        self.rx = p["DvbsReceiver"](p["RxConfig"](**rc), device=self.device)
        self.read_iq = p["read_iq"]
        cap = stimulus.make_capture(self.traffic, self.seed, self.device,
                                    extra=self.R)
        self.cap = cap
        self.raw = cap.iq[0].cpu().numpy().reshape(-1)     # I, Q words
        cap.iq = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ch = self.cfg["check"]
        self.ref_offset = int(self.rng.integers(ch["demod_read_lo"],
                                                ch["demod_read_hi"]))
        self.captured = {}
        self.blocks = []
        # Faults lie under the capture, which keeps what the faulty path
        # produced.
        if self.fault:
            self._install_fault()
        self._install_capture()
        if self.trace:
            self._install_spans()
        for _ in range(self.cfg["warmup_inputs"]):
            self.hand_over(time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _bytes(self, j: int) -> bytes:
        o = (j * self.R) % self.cap.period
        return self.raw[2 * o:2 * (o + self.R)].tobytes()

    def _submit(self) -> list:
        return [[self.rx.process(self.read_iq(self._bytes(self.unit),
                                              self.format))]]

    def _sampled(self, k: int) -> bool:
        return (self.window_first is not None
                and self.unit - self.window_first == k)

    def _install_capture(self):
        """Keep what the check compares: the notch's state before the read
        ahead of the sampled one, the demod's input state and output of the
        sampled read, the first read's demod output, and each block of the
        hard decoder in the window with the state it started from."""
        rk = _program()["rk"]
        demod = rk.demod
        drv = self
        k0 = self.ref_offset
        notch = self.rx.notch.b

        def demod_wrap(params, sym_consts, planes, x):
            out = demod(params, sym_consts, planes, x)
            if drv.unit == 0 and "start" not in drv.captured:
                drv.captured["start"] = out[1]
            if drv._sampled(k0):
                drv.captured["demod"] = (planes.clone(), out[1])
            return out

        notch_process = self.rx.notch.process

        def notch_wrap(z):
            if drv._sampled(k0 - 1):
                drv.captured["notch"] = (notch.slot_i[0].copy(),
                                         notch.estim[0].copy(),
                                         float(notch.gain[0]), notch.phase)
            return notch_process(z)

        dc = self.rx.deconv
        block = dc._process_block

        def block_wrap(symbols):
            backlog, skip = dc.backlog, dc.skip
            out = block(symbols)
            if drv.window_first is not None:
                # The state it started from, the sync it decoded under
                # (after a fastlock election), its input and its bytes.
                drv.blocks.append((backlog, skip, dc.locked, symbols, out))
            return out

        self.patches.set(rk, "demod", demod_wrap)
        self.patches.set(self.rx.notch, "process", notch_wrap)
        self.patches.set(dc, "_process_block", block_wrap)

    def _install_fault(self):
        rk = _program()["rk"]
        demod = rk.demod
        f = self.fault
        if f == "dec":
            dc = self.rx.deconv
            block = dc._process_block

            def block_fault(symbols):
                out = block(symbols)
                if len(out):
                    out = out.copy()
                    out[len(out) // 2] ^= 0x01
                return out
            self.patches.set(dc, "_process_block", block_fault)
        elif f in ("state", "sym"):
            def demod_fault(params, sym_consts, planes, x):
                st, packed = demod(params, sym_consts, planes, x)
                if f == "state":
                    return planes, packed
                packed = packed.clone()
                packed[::97] ^= 1 << 16
                return st, packed
            self.patches.set(rk, "demod", demod_fault)
        else:
            stages = self.rx._byte_stages

            def stages_fault(b):
                out = stages(b)
                if len(out):
                    out = out.copy()
                    out[0, 100] ^= 0x01
                return out
            self.patches.set(self.rx, "_byte_stages", stages_fault)

    def _install_spans(self):
        sp = self.spans
        self.patches.set(self.rx.notch, "process",
                         sp.host_span("notch", self.rx.notch.process))
        self.patches.set(self.rx.deconv, "process",
                         sp.host_span("deconv", self.rx.deconv.process))
        self.patches.set(self.rx, "_byte_stages",
                         sp.host_span("bytes", self.rx._byte_stages))

    def release(self):
        self.patches.close()
        k = self.window_first + self.ref_offset
        self.reads_for_check = {"sampled": self._bytes(k - 1) + self._bytes(k),
                                "start": self._bytes(0)}
        self.captured = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else tuple(a.cpu().numpy() if isinstance(
                             a, torch.Tensor) else a for a in v)
                         for k, v in self.captured.items()}
        del self.rx
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def check(self) -> dict:
        """The numbers compared: the TS packets against the packets sent;
        each block of the hard decoder against the plain deconvolver's
        from the same state and symbols (dec_diff, the share of bytes
        that differ); the demod against the reference (soft_check). The
        decoder's bytes against the bits sent (dec_ber) are a diagnostic:
        at this stream's MER (~12.6 dB behind the linear sampler) real
        symbol errors pass through the algebraic deconvolver, and RS
        corrects them."""
        s = self.settled
        out = dict(ts_bad=s["bad"], ts_lost=s["lost"] + s["undelivered"])
        bad = total = 0
        for backlog, skip, locked, symbols, got in self.blocks:
            b = np.concatenate([backlog, symbols])[skip:]
            want, _ = reference.deconvolve(b, locked)
            n = min(len(want), len(got))
            bad += int((want[:n] != got[:n]).sum()) + abs(len(want)
                                                          - len(got))
            total += max(len(want), len(got))
        out["dec_diff"] = bad / total if total else 1.0
        d = (np.concatenate([blk[4] for blk in self.blocks]) if self.blocks
             else np.zeros(0, np.uint8))
        e, nb, _ = check.stream_errors(d, self.cap.stream[0])
        self.diagnostics = dict(dec_ber=e / nb if nb else 1.0, dec_bits=nb)
        out.update(self.soft_check())
        return out

    def _soft(self, precision: str) -> dict:
        """The reference at `precision`: the notch from the program's
        notch state over the read before the sampled one and the sampled
        read, then the demod over the sampled read's first rows from the
        program's demod state (and over the whole read when the state
        handed on is compared); and the first read from the cold state."""
        if precision in self._soft_cache:
            return self._soft_cache[precision]
        rc = self.cfg["receiver"]
        ch = self.cfg["check"]
        K = reference.loop_constants(rc["Fs"] / rc["Fm"], 1.0)
        trig = reference.trig_table(self.device)
        out = {}
        scale = np.float32(rc["float_scale"])
        raw = reference.decode_iq(self.reads_for_check["sampled"],
                                  self.format) * scale
        z = reference.Notch(rc["anf"], self.device,
                            self.captured["notch"]).process(raw)
        # The sampled read's demod spans [j R - 128, (j + 1) R - 128) of
        # the stream, plus its one sample of lookahead: z starts at
        # (j - 1) R.
        lo = self.R - reference.CHUNK
        n = ch["demod_samples"]
        planes = self.captured["demod"][0]
        out["sampled"] = reference.demod(K, trig, planes,
                                         z[None, lo:lo + n + 1], precision)
        raw0 = reference.decode_iq(self.reads_for_check["start"],
                                   self.format) * scale
        z0 = reference.Notch(rc["anf"], self.device).process(raw0)
        n0 = ch["start_samples"]
        out["start"] = reference.demod(K, trig, reference.init_state(1),
                                       z0[None, :n0 + 1], precision)
        self._soft_cache[precision] = out
        return out

    def soft_check(self) -> dict:
        if "demod" not in self.captured or "notch" not in self.captured:
            return dict(demod_diff=1.0, start_diff=1.0)
        r = self._soft("fp32")
        n = self.cfg["check"]["demod_samples"]
        n0 = self.cfg["check"]["start_samples"]
        return self._compare(r, dict(
            sampled=_unpack(self.captured["demod"][1][:n]),
            start=_unpack(self.captured["start"][:n0])))

    def control_check(self, precision: str) -> dict:
        r = self._soft("fp32")
        c = self._soft(precision)
        return self._compare(r, dict(sampled=c["sampled"][1:],
                                     start=c["start"][1:]))

    @staticmethod
    def _compare(r, p) -> dict:
        return dict(demod_diff=compare_soft(*r["sampled"][1:], *p["sampled"]),
                    start_diff=compare_soft(*r["start"][1:], *p["start"]))


def _unpack(packed: np.ndarray) -> tuple:
    """The demod's packed words [n, 1] -> (sym, valid, cost)."""
    p = np.asarray(packed).astype(np.int64)
    return (((p >> 16) & 0xFF).astype(np.uint8), ((p >> 24) & 1).astype(bool),
            (-(p & 0xFFFF)).astype(np.int16))

