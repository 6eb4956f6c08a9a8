"""Driver of the multi-carrier DVB-S receiver (leansdr_tpu_torch's
`pipelines/multi_rx.MultiDvbsReceiver`) through its streaming entry,
`submit()` and `flush()`, as `apps/leandvbfleet.py` drives it, with each
chunk handed over already on the card (the device-resident path of
`dispatch`).

Set-up builds the capture and the receiver and drives the receiver
through its first `warmup_inputs` chunks with the same calls the window
makes (the sequential hold-off chunks, the first segmented ones, the
decoder's entry into TRACK). The window then reads the capture on from
there, looping it, at the traffic's pace.
"""

import time

import numpy as np
import torch

from sdrbench import check, reference, stimulus
from sdrbench.check import compare_soft
from sdrbench.harness import StreamDriver


def _program():
    """The program's modules the driver calls and wraps."""
    from leansdr_tpu_torch.dsp import mf_prefilter
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.fec import viterbi_device as vd
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    return dict(mf=mf_prefilter, rk=rk, Predef=Predef, vd=vd,
                multi_rx=multi_rx, RxConfig=RxConfig)


class Driver(StreamDriver):
    """One run of a fleet cell (harness.StreamDriver)."""

    FAULTS = ("state", "half", "ts", "dec", "sym")

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        super().__init__(config, traffic, seed, device, trace)
        self.nchan = self.C = int(traffic["carriers"])
        self.step = self.chunk = int(config["chunk_samples"])
        self.S = int(config["segments"])
        self.kernel_shapes = {"demod": [], "acs": []}
        self._soft_cache = {}

    # ------------------------------------------------------------ set-up

    def build_receiver(self):
        p = _program()
        rc = dict(self.cfg["receiver"])
        rc["constellation"] = p["Predef"][rc["constellation"]]
        # The chunks are handed over with float_scale already applied, as
        # the device-resident path of dispatch() takes them.
        rc["float_scale"] = 1.0
        return p["multi_rx"].MultiDvbsReceiver(
            p["RxConfig"](**rc), self.C, chunk_samples=self.chunk,
            segments=self.cfg["segments"], seg_warmup=self.cfg["seg_warmup"],
            seg_holdoff=self.cfg["seg_holdoff"], device=self.device)

    def setup(self):
        self.rx = self.build_receiver()
        self.ra = self.rx.readahead
        self.cap = stimulus.make_capture(
            self.traffic, self.seed, self.device, extra=self.chunk + self.ra,
            float_scale=self.cfg["receiver"]["float_scale"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # What the check samples, drawn from the seed: carriers for the
        # soft layers and for the decoder's bytes, and the window chunk
        # whose demod the reference works out again.
        ch = self.cfg["check"]
        self.ref_carriers = np.sort(self.rng.choice(
            self.C, min(ch["demod_carriers"], self.C), replace=False))
        self.dec_carriers = np.sort(self.rng.choice(
            self.C, min(ch["decoder_carriers"], self.C), replace=False))
        self.ref_offset = int(self.rng.integers(ch["demod_chunk_lo"],
                                                ch["demod_chunk_hi"]))
        self.modes = []                 # the decoder in TRACK at hand-over
        self.captured = {}
        self.decoded = [[] for _ in self.dec_carriers]
        # A fault where the demod produces lies under the capture; one on
        # the decoder's bytes or the TS packets over it, so that what the
        # check reads is what the faulty path produced.
        if self.fault in ("state", "sym"):
            self._install_fault(self.fault)
        self._install_capture()
        if self.fault in ("half", "ts", "dec"):
            self._install_fault(self.fault)
        if self.trace:
            self._install_spans()
        for _ in range(self.cfg["warmup_inputs"]):
            self.hand_over(time.perf_counter())
        self.rx.flush()
        self.track_at_window = bool(getattr(self.rx.deconv, "track", False))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _chunk_view(self, j: int) -> torch.Tensor:
        o = (j * self.chunk) % self.cap.period
        return self.cap.iq[:, o:o + self.chunk + self.ra]

    def _submit(self) -> list:
        self.modes.append(bool(getattr(self.rx.deconv, "track", False)))
        x = self._chunk_view(self.unit)
        if self.device.type != "cuda":
            # The host path (the CPU, in the tests) buffers what it is
            # given: hand it the samples past the first chunk's readahead
            # once, so its chunks fall where the device path's do.
            x = x[:, :self.chunk + self.ra] if self.unit == 0 else \
                x[:, self.ra:]
        return self.rx.submit(x)

    def _drain(self) -> list:
        return self.rx.flush()

    def _sampled(self) -> bool:
        return (self.window_first is not None
                and self.unit - self.window_first == self.ref_offset)

    def _install_capture(self):
        """Keep what the check compares: the demod's inputs and outputs
        of the sampled chunk (the segmented engine's, or with one segment
        the demod's), chunk 0's first demod (the cold start), and the
        decoder's bytes of the sampled carriers. References only, no
        copies in the window."""
        p = _program()
        mr = p["multi_rx"]
        seg, dem = mr._demod_segmented, mr.demod
        drv = self

        def seg_wrap(params, sym_consts, mf_taps, nchan, S, W, want_cost,
                     dem_state, seg_state, x, tables=None):
            out = seg(params, sym_consts, mf_taps, nchan, S, W, want_cost,
                      dem_state, seg_state, x, tables=tables)
            if drv._sampled():
                drv.captured["seg"] = (S, W, dem_state, seg_state, out)
            return out

        def dem_wrap(params, sym_consts, tables, st, x):
            out = dem(params, sym_consts, tables, st, x)
            if drv.unit == 0 and "start" not in drv.captured:
                drv.captured["start"] = out
            if drv.S == 1 and drv._sampled():
                drv.captured["seq"] = (st, out)
            return out

        self.patches.set(mr, "_demod_segmented", seg_wrap)
        self.patches.set(mr, "demod", dem_wrap)
        feed = self.rx.backend.feed

        def feed_wrap(bytes_by_chan):
            if drv.window_first is not None:
                for i, c in enumerate(drv.dec_carriers):
                    drv.decoded[i].append(bytes_by_chan[c])
            return feed(bytes_by_chan)

        self.patches.set(self.rx.backend, "feed", feed_wrap)

    def plant(self, fault: str):
        """Break the timed path for the fault test (before setup()):
        "state", the demod (the segmented engine, with segments) hands its
        input state on unchanged; "half", the second half of the carriers'
        decoded bytes never reach the back end; "ts", one byte of the
        first TS packet a call gives back on each carrier is altered;
        "dec", one bit of each carrier's decoded bytes per chunk is
        flipped; "sym", every 97th symbol of the demod's output is
        relabelled."""
        super().plant(fault)

    def _install_fault(self, fault: str):
        mr = _program()["multi_rx"]
        # The demod the chunks go through: the segmented engine, whose
        # states are its arguments 7 and 8 and whose symbols are its
        # output 2, or with one segment the demod (state 3, symbols 1).
        name, states, symbols = (("_demod_segmented", (7, 8), 2)
                                 if self.S > 1 else ("demod", (3,), 1))
        dem = getattr(mr, name)
        feed = self.rx.backend.feed
        half = self.C // 2

        def dem_state(*a, **kw):
            out = dem(*a, **kw)
            return tuple(a[i] for i in states) + tuple(out[len(states):])

        def dem_sym(*a, **kw):
            out = list(dem(*a, **kw))
            out[symbols] = out[symbols].clone()
            out[symbols][::97] ^= 1
            return tuple(out)

        def feed_half(b):
            return feed([x if c < half else x[:0] for c, x in enumerate(b)])

        def feed_ts(b):
            out = feed(b)
            for p in out:
                if len(p):
                    p[0, 100] ^= 0x01
            return out

        def feed_dec(b):
            b = [x.copy() for x in b]
            for x in b:
                if len(x):
                    x[len(x) // 2] ^= 0x01
            return feed(b)

        if fault == "state":
            self.patches.set(mr, name, dem_state)
        elif fault == "sym":
            self.patches.set(mr, name, dem_sym)
        else:
            self.patches.set(self.rx.backend, "feed", dict(
                half=feed_half, ts=feed_ts, dec=feed_dec)[fault])

    def _install_spans(self):
        """The traced run's spans around calls into the program's layers
        (over the capture wrappers): host-clock spans of the entry and the
        back end, profiler scopes of the engine, the matched filter and
        demod launches inside it, and the decoder; the demod and ACS
        kernels' launch shapes."""
        p = _program()
        mr, rk, vd, mf = p["multi_rx"], p["rk"], p["vd"], p["mf"]
        sp = self.spans
        shapes = self.kernel_shapes
        demod, acs = rk.demod, vd.viterbi_acs

        def demod_shape(params, sym_consts, planes, x):
            shapes["demod"].append((self.unit, x.shape[0], x.shape[1] - 1))
            return demod(params, sym_consts, planes, x)

        def acs_shape(rate, metric, path, cs, cost, cheap_q=False):
            shapes["acs"].append((self.unit, cs.shape[0], cs.shape[1]))
            return acs(rate, metric, path, cs, cost, cheap_q)

        self.patches.set(rk, "demod", sp.scope("demod", demod_shape))
        self.patches.set(vd, "viterbi_acs", acs_shape)
        self.patches.set(mf, "mf_prefilter",
                         sp.scope("mf", mf.mf_prefilter))
        self.patches.set(mr, "_demod_segmented",
                         sp.scope("segmented", mr._demod_segmented))
        self.patches.set(vd, "viterbi_decode",
                         sp.scope("decode", vd.viterbi_decode))
        self.patches.set(self.rx, "dispatch",
                         sp.host_span("dispatch", self.rx.dispatch))
        self.patches.set(self.rx.backend, "feed",
                         sp.host_span("backend", self.rx.backend.feed))

    def _extras(self) -> dict:
        return dict(track=self.track_at_window,
                    track_share=float(np.mean(self.modes[self.window_first:])))

    def release(self):
        """Free the program's state before the check: stop its threads,
        restore every wrapped attribute, drop the receiver and copy to the
        host what the check reads of the capture."""
        self.rx.close()
        self.patches.close()
        cs = torch.from_numpy(self.ref_carriers).to(self.device)
        need = {}
        if "seg" in self.captured or "seq" in self.captured:
            j = self.window_first + self.ref_offset
            need["chunk"] = self._chunk_view(j)[cs].cpu()
        need["start"] = self._chunk_view(0)[cs].cpu()
        self.chunks_for_check = need
        self.captured = {k: _to_cpu(v) for k, v in self.captured.items()}
        del self.rx
        self.cap.iq = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def check(self) -> dict:
        """The numbers compared, each as measured (limits are the
        configuration's)."""
        out = {}
        s = self.settled
        out["ts_bad"] = s["bad"]
        out["ts_lost"] = s["lost"] + s["undelivered"]
        errs = bits = lost = 0
        for i, c in enumerate(self.dec_carriers):
            d = self.decoded[i]
            d = np.concatenate(d) if d else np.zeros(0, np.uint8)
            skip = self.cfg["check"]["decoder_skip_bytes"]
            e, b, l = check.stream_errors(d[skip:], self.cap.stream[c])
            errs, bits, lost = errs + e, bits + b, lost + l
        out["dec_ber"] = errs / bits if bits else 1.0
        self.diagnostics = dict(dec_bits=bits, dec_blocks_unplaced=lost)
        out.update(self.soft_check())
        return out

    def reference_demod(self, precision: str = "fp32"):
        rc = self.cfg["receiver"]
        pll = 1.0 / 6 if rc["viterbi"] else 1.0
        return reference.Demod(rc["Fs"], rc["Fm"], rc["rolloff"],
                               rc["rrc_rej"], pll, self.device, precision)

    def _soft(self, precision: str) -> dict:
        """The reference's (sym, valid, cost) at `precision` for the
        sampled chunk, from the program's states at its start (the whole
        chunk through the segmented engine; with one segment, its first
        `demod_samples` rows), and for the cold start (from its own cold
        state), for the sampled carriers."""
        if precision in self._soft_cache:
            return self._soft_cache[precision]
        ref = self.reference_demod(precision)
        cs = self.ref_carriers
        ch = self.cfg["check"]
        out = {}
        if "seg" in self.captured:
            S, W, dem_in, seg_in, _ = self.captured["seg"]
            out["chunk"] = ref.segmented(S, W, dem_in[:, cs],
                                         seg_in[:, self._lanes(S)],
                                         self.chunks_for_check["chunk"])[2:]
        elif "seq" in self.captured:
            n = ch["demod_samples"]
            x = self.chunks_for_check["chunk"][:, :n + ref.readahead]
            out["chunk"] = ref.run(self.captured["seq"][0][:, cs], x)[1:]
        n0 = ch["start_samples"]
        x0 = self.chunks_for_check["start"][:, :n0 + ref.readahead]
        out["start"] = ref.run(reference.init_state(len(cs)), x0)[1:]
        self._soft_cache[precision] = out
        return out

    def _lanes(self, S: int) -> np.ndarray:
        """The segment lanes (s * C + c) of the sampled carriers."""
        return (np.arange(S)[:, None] * self.C
                + self.ref_carriers[None, :]).reshape(-1)

    def soft_check(self) -> dict:
        """The share of rows of the sampled chunk and carriers where the
        demod's validity, symbol or cost differs from the reference's
        from the program's state at the chunk's start (demod_diff), and
        the same over chunk 0's first rows from the cold state
        (start_diff)."""
        cs = self.ref_carriers
        if "seg" in self.captured:
            prog = self.captured["seg"][4][2:]
        elif "seq" in self.captured:
            n = self.cfg["check"]["demod_samples"]
            prog = tuple(a[:n] for a in self.captured["seq"][1][1:])
        else:
            return dict(demod_diff=1.0, start_diff=1.0)
        n0 = self.cfg["check"]["start_samples"]
        return self._compare(self._soft("fp32"), dict(
            chunk=tuple(a[:, cs] for a in prog),
            start=tuple(a[:n0, cs] for a in self.captured["start"][1:])))

    def control_check(self, precision: str) -> dict:
        """The same comparisons with the reference at `precision` in the
        program's place."""
        return self._compare(self._soft("fp32"), self._soft(precision))

    @staticmethod
    def _compare(r: dict, p: dict) -> dict:
        return dict(demod_diff=compare_soft(*r["chunk"], *p["chunk"]),
                    start_diff=compare_soft(*r["start"], *p["start"]))


def _to_cpu(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_to_cpu(x) for x in v)
    return v
