#!/usr/bin/env python3
"""Smoke test of leansdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from leansdr_tpu_torch/csrc (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the fleet receiver's main path at full width — 64 QPSK carriers at
2 Msym/s sampled at 4 Msps, chunk_samples = 2**18, Viterbi on — at code
rate 1/2 (the rate-1/2 ACS kernel) and at the punctured rates 3/4 and 7/8
(the banked ACS kernel), from DVB-S stimulus the port modulates itself,
and checks that every carrier locks and decodes the TS packets that were
sent.

Phases (any failure exits non-zero):
  1. card name and power limit, versions, kernel build time;
  2. demod kernel == demod_ref (QPSK at C=64 and C=8192, 8PSK at C=64;
     4096 samples: the plain version costs one launch per op per sample).
     Tolerance: valid exactly on every sample, symbol and cost exactly on
     every valid sample, float state within max(1e-3, 1e-4*|v|) (the CPU
     tests' bar; the kernel and its plain version round alike, so 0 is
     expected);
  3. ACS kernel == viterbi_acs_ref bit for bit (T=2048, ties forced, the
     main path's N=256 ACQUIRE lanes with and without cheap_q, its N=64
     TRACK lanes with cheap_q); banked ACS kernel ==
     viterbi_acs_banked_ref bit for bit at 4/6, 3/4, 5/6 and 7/8 (T=1024,
     ties forced, from zero and from a live state, at each rate's
     main-path ACQUIRE lanes, at TRACK's 64 and at N=200);
  4. the main path through MultiDvbsReceiver.process, with the kernels'
     launch counters zeroed just before and read just after, and
     per-stage times from CUDA events; at rate 1/2 then the same stream
     through the pipelined submit()/flush() path (device->host copy and
     byte backend on threads), held to the same TS gate; then 64
     carriers at 3/4 and at 7/8, each run with its own zeroed counters;
  5. kernel times at the main path's shapes, bounds, one `kernels` line;
  6. last line: {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
NCHAN = 64
CHUNK_SAMPLES = 1 << 18
NCHUNKS = 6
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
VECTOR_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# Integer work (the ACS kernels) is priced at the INT32 issue rate: a
# Hopper SM has 64 INT32 lanes, so 64 integer operations per SM per
# clock, times the SMs (132 on the H100 SXM) and the max SM clock that
# nvidia-smi reports (1980 MHz there): ~16.7e12/s. The 67e12 above is the
# FP32 FMA rate counting each FMA as two operations, 4x the INT32 rate.
INT32_OPS_PER_SM_CLOCK = 64
PUNCTURED = ("3/4", "7/8")       # main-path rates of the banked ACS
STATE_KEYS = {"mu": 0, "freqw": 2, "agc_gain": 3, "est_insp": 4}
# The demod's serial bound: dependent operations per sample along
# demod.cu's loop-carried path (phase -> u16 wrap 7, sinf/cosf ~25,
# rotate + interpolate + AGC 7, halving + decision 11, atan2_poly with
# its IEEE division ~30, pe16 fold 8, PLL update 4), each at least the
# 4-cycle dependent-issue latency of Hopper's FP32/INT32 pipes.
DEMOD_CHAIN_OPS = 90
DEP_LATENCY_CYCLES = 4


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of fn() from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(nbytes: float, nops: float, ops_per_s: float = VECTOR_OPS_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def int32_ops_per_s(clock_hz: float) -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_CLOCK * sms * clock_hz


# ---------------------------------------------------------------- phase 2

def demod_stimulus(predef, rate, C, nsamp, dev, gen):
    """[C, nsamp+1, 2] float32 on dev at the AGC setpoint amplitude:
    QPSK from the port's own modulator, other constellations as noisy
    random symbols; per-channel sample offsets, fractional delays and
    noise from the seeded generator."""
    from leansdr_tpu_torch.dsp.cstln import make_dvbs2_constellation
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    if rate == "1/2":
        base = dvbs_tx.modulate(tsgen.generate(40),
                                dvbs_tx.TxConfig(rate=rate, interp=2))
        base = torch.from_numpy(base * np.float32(75.0)).to(dev)
    else:
        cst = make_dvbs2_constellation(predef, rate)
        pts = torch.from_numpy(cst.symbols.astype(np.float32)).to(dev)
        ix = torch.randint(0, cst.nsymbols, (nsamp + 4096,), device=dev,
                           generator=gen)
        base = pts[ix].repeat_interleave(2, dim=0)
    L = base.shape[0] - 1
    offs = torch.randint(0, L - nsamp - 2, (C, 1), device=dev, generator=gen)
    idx = offs + torch.arange(nsamp + 1, device=dev)[None, :]
    d = torch.rand((C, 1, 1), device=dev, generator=gen)
    x = (1 - d) * base[idx] + d * base[idx + 1]
    x = x + 4.0 * torch.randn(x.shape, device=dev, generator=gen)
    return x.to(torch.float32).contiguous()


def check_demod(predef, rate, nsym, C, nsamp, dev, gen):
    from leansdr_tpu_torch.dsp import receiver, receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import make_dvbs2_constellation
    cst = make_dvbs2_constellation(predef, rate)
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=nsym, exact_lut=False,
                                     pll_adjustment=1.0 / 6)
    sc = rk.sym_constants(cst)
    x = demod_stimulus(predef, rate, C, nsamp, dev, gen)
    planes = rk.pack_state(receiver.init_state(params, C, dev))
    st_k, pk_k = rk.demod(params, sc, planes, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_r, pk_r = rk.demod_ref(params, sc, planes, x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    vk, vr = (pk_k >> 24) & 1, (pk_r >> 24) & 1
    bad = int(((vk != vr) | ((pk_k != pk_r) & (vr == 1))).sum())
    words = int((pk_k != pk_r).sum())
    nvalid = int(vr.sum())
    err = 0.0
    for k, row in STATE_KEYS.items():
        a, b = st_k[row], st_r[row]
        e = float((a - b).abs().max())
        tol = max(1e-3, 1e-4 * float(b.abs().max()))
        if not e <= tol:
            fail(f"demod {predef.name} C={C}: state {k} differs by {e}")
        err = max(err, e)
    print(f"demod {predef.name:6s} C={C:5d} nsamp={nsamp}: valid symbols "
          f"{nvalid}, mismatches at valid samples {bad}, differing words "
          f"{words}, state max |d| {err:.3g}, plain {plain_ms:.0f} ms")
    if bad or nvalid < C * nsamp // 4:
        fail(f"demod kernel != demod_ref ({predef.name}, C={C})")
    return err, plain_ms


# ---------------------------------------------------------------- phase 3

def check_acs(dev, gen):
    from leansdr_tpu_torch.fec import viterbi_device as vd
    T = 2048
    out = []
    for N, cheap_q in ((NCHAN * vd.NSYNCS, False), (NCHAN * vd.NSYNCS, True),
                       (NCHAN, True)):
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)
        m0, p0 = z, z
        for rnd in range(2):      # second round starts from a live state
            cs = torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                               generator=gen)
            cost = -torch.randint(0, 4, (T, N), device=dev,
                                  dtype=torch.int32, generator=gen)
            k = vd.viterbi_acs("1/2", m0, p0, cs, cost, cheap_q=cheap_q)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = vd.viterbi_acs_ref("1/2", m0, p0, cs, cost, cheap_q=cheap_q)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for name, a, b in zip(("metric", "path", "us", "q"), k, r):
                if not torch.equal(a, b):
                    fail(f"ACS N={N} cheap_q={cheap_q} round {rnd}: {name} "
                         f"differs in {int((a != b).sum())} entries")
            err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs()
                            .max()) for a, b in zip(k, r))
            print(f"acs cheap_q={cheap_q!s:5s} N={N} T={T} round {rnd}: "
                  f"bit-equal, plain {plain_ms:.0f} ms")
            out.append((err, plain_ms))
            m0, p0 = k[0], k[1]
    return max(e for e, _ in out), out[0][1]


def fleet_plan(rate, dev):
    """The ACQUIRE ViterbiPlan of the 64-carrier main path at `rate`."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec import viterbi_device as vd
    return vd.MultiViterbiSync(make_dvbs2_constellation(Predef.QPSK, rate),
                               rate, NCHAN, CHUNK_SAMPLES, 2.0,
                               device=dev).plan


def check_acs_banked(dev, gen):
    """acs_banked == viterbi_acs_banked_ref bit for bit at every fleet
    punctured rate, T=1024, coarse costs forcing metric ties, at the main
    path's lane counts (the rate's ACQUIRE lanes, 64 carriers x nsyncs,
    and TRACK's 64) and at N=200 (not a multiple of 32); round 0 from
    zero planes, round 1 from the kernel's end state. Returns (max |diff|,
    plain ms at 3/4 ACQUIRE round 0, its N)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    T = 1024
    err, plain = 0.0, None
    for rate in vb.FLEET_RATES:
        ncs = make_trellis(rate).ncs
        n_acq = fleet_plan(rate, dev).n_lanes
        for N in (n_acq, NCHAN, 200):
            z = torch.zeros((64, N), dtype=torch.int32, device=dev)
            planes = (z, z, z)
            for rnd in range(2):
                cs = torch.randint(0, ncs, (T, N), device=dev,
                                   dtype=torch.int32, generator=gen)
                cost = -3 * torch.randint(0, 4, (T, N), device=dev,
                                          dtype=torch.int32, generator=gen)
                k = vb.viterbi_acs_banked(rate, *planes, cs, cost)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = vb.viterbi_acs_banked_ref(rate, *planes, cs, cost)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                for name, a, b in zip(("metric", "hi", "lo", "us", "q"), k,
                                      r):
                    if not torch.equal(a, b):
                        fail(f"acs_banked {rate} N={N} round {rnd}: {name} "
                             f"differs in {int((a != b).sum())} entries")
                err = max(err, max(float((a.to(torch.int64)
                                          - b.to(torch.int64)).abs().max())
                                   for a, b in zip(k, r)))
                print(f"acs_banked {rate} N={N} T={T} round {rnd}: "
                      f"bit-equal, plain {plain_ms:.0f} ms")
                if rate == "3/4" and N == n_acq and rnd == 0:
                    plain = (plain_ms, N)
                planes = k[:3]
    return err, plain[0], plain[1]


# ---------------------------------------------------------------- phase 4

def fleet_stimulus(dev, gen, nsamp, rate="1/2"):
    """[64, nsamp, 2] float32 on dev: channel c carries the port's
    modulation at code rate `rate` of TS packets numbered from 1000*c,
    with its own fractional delay, carrier offset and AWGN (Es/N0
    ~ 12 dB)."""
    from leansdr_tpu_torch.fec.convenc import FEC_SPECS
    from leansdr_tpu_torch.fec.viterbi_banked import fleet_rate
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    bits_in, bits_out = FEC_SPECS[fleet_rate(rate)]
    # A TS packet takes at least 188*8 * bits_out/bits_in samples (2
    # samples per symbol, 2 coded bits per symbol), so these cover nsamp.
    npkt = nsamp * bits_in // (1504 * bits_out) + 16
    rows = []
    for c in range(NCHAN):
        q = dvbs_tx.modulate(tsgen.generate(npkt, start=1000 * c),
                             dvbs_tx.TxConfig(rate=rate, interp=2))
        if len(q) < nsamp + 1:
            fail(f"stimulus: {len(q)} samples < {nsamp + 1}")
        rows.append(torch.from_numpy(q[:nsamp + 1]))
    x = torch.stack(rows).to(dev)                       # [C, nsamp+1, 2]
    d = torch.rand((NCHAN, 1, 1), device=dev, generator=gen)
    x = (1 - d) * x[:, :-1] + d * x[:, 1:]
    rms = float(x.square().sum(-1).mean().sqrt())
    f = (torch.arange(NCHAN, device=dev, dtype=torch.float64) - 32) * 5e-6
    t = torch.arange(nsamp, device=dev, dtype=torch.float64)
    ph = (2 * np.pi * f[:, None] * t[None, :]).remainder(2 * np.pi)
    cr, sr = ph.cos().float(), ph.sin().float()
    xr, xi = x[..., 0], x[..., 1]
    y = torch.stack([xr * cr - xi * sr, xr * sr + xi * cr], -1)
    sigma = rms * 10 ** (-12 / 20) / np.sqrt(2)
    y = y + sigma * torch.randn(y.shape, device=dev, generator=gen)
    return y.contiguous()


def check_packets(c, pkts):
    """Decoded packets of channel c: from the first packet that equals a
    sent one (the derandomizer's first sync) on, the fraction that are
    sent packets, and how many of the packets sent in that span came
    out. Returns (n_after_lock, n_good, n_span)."""
    from leansdr_tpu_torch.pipelines import tsgen
    nums = [(int(p[1]) << 16 | int(p[2]) << 8 | int(p[3])) for p in pkts]
    ok = [0 <= n - 1000 * c < 10000
          and (tsgen.generate(1, start=n)[0] == p).all()
          for n, p in zip(nums, pkts)]
    if not any(ok):
        return 0, 0, 1
    first = ok.index(True)
    good = sorted({n for n, o in zip(nums[first:], ok[first:]) if o})
    span = good[-1] - good[0] + 1
    return len(pkts) - first, sum(ok[first:]), span


def main_path(dev, gen, code_rate="1/2"):
    """The fleet at `code_rate`: NCHUNKS chunks through process() with
    every kernel's launch count zeroed just before and read just after;
    at rate 1/2 also the pipelined submit() path."""
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig

    cfg = RxConfig(Fs=4e6, Fm=2e6, rate=code_rate, fastlock=True,
                   float_scale=75, exact_lut=False, viterbi=True,
                   sampler="rrc")
    rx = multi_rx.MultiDvbsReceiver(cfg, NCHAN, chunk_samples=CHUNK_SAMPLES,
                                    device=dev)
    ra = rx.readahead
    t0 = time.perf_counter()
    frames = fleet_stimulus(dev, gen, NCHUNKS * CHUNK_SAMPLES + ra,
                            code_rate)
    frames = frames * cfg.float_scale       # the device path's contract
    torch.cuda.synchronize()
    print(f"[rate {code_rate}] stimulus: {NCHAN} x {frames.shape[1]} "
          f"samples in {time.perf_counter() - t0:.1f} s")

    # Per-stage CUDA events (host clocks for the host stages) around the
    # main path's own calls, tagged with the chunk they belong to.
    chunk = [0]
    marks = []                                   # (chunk, stage, s, e)
    host = []                                    # (chunk, stage, ms)

    def timed(name, fn):
        def wrapper(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            marks.append((chunk[0], name, s, e))
            return out
        return wrapper

    def hosttimed(name, fn, sync=False):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            host.append((chunk[0], name, (time.perf_counter() - t) * 1e3))
            return out
        return wrapper

    demod_fn, acs_fn, banked_fn = rk.demod, vd.viterbi_acs, \
        vb.viterbi_acs_banked
    patches = [(mf_prefilter, "mf_prefilter", timed("mf", mf_prefilter.
                                                   mf_prefilter)),
               (rk, "demod", timed("demod", rk.demod)),
               (multi_rx, "deconv_append", timed("append",
                                                 multi_rx.deconv_append)),
               (vd, "viterbi_decode", timed("decode", vd.viterbi_decode)),
               (vd, "viterbi_decode_banked", timed(
                   "decode", vd.viterbi_decode_banked)),
               (multi_rx, "_pack_fetch", timed("pack", multi_rx._pack_fetch)),
               (multi_rx, "_to_host", hosttimed("fetch", multi_rx._to_host,
                                                sync=True)),
               (rx.backend, "feed", hosttimed("backend", rx.backend.feed))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)

    pkts = [[] for _ in range(NCHAN)]
    wall = []
    demod_fn.launches = 0
    acs_fn.launches = 0
    banked_fn.launches = 0
    try:
        for k in range(NCHUNKS):
            chunk[0] = k
            x = frames[:, k * CHUNK_SAMPLES:(k + 1) * CHUNK_SAMPLES + ra]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = rx.process(x)
            wall.append(time.perf_counter() - t)
            for c in range(NCHAN):
                pkts[c] += list(out[c])
    finally:
        launches = {"demod": demod_fn.launches, "acs": acs_fn.launches,
                    "acs_banked": banked_fn.launches}
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    torch.cuda.synchronize()

    acs_key = "acs" if code_rate == "1/2" else "acs_banked"
    print(f"[rate {code_rate}] main path: {NCHUNKS} chunks of {NCHAN} x "
          f"{CHUNK_SAMPLES}; launches {launches}; TRACK={rx.deconv.track}")
    if launches["demod"] < NCHUNKS or launches[acs_key] < 1:
        fail(f"main path at rate {code_rate} did not run through the "
             f"kernels: {launches}")
    locks = rx.locks
    if not all(locks):
        fail(f"rate {code_rate}: channels not locked: "
             f"{[c for c, l in enumerate(locks) if not l]}")
    worst = 1.0
    total_good = 0
    for c in range(NCHAN):
        n_after, n_good, span = check_packets(c, pkts[c])
        frac_ok = n_good / max(n_after, 1)
        frac_span = n_good / span
        worst = min(worst, frac_ok, frac_span)
        total_good += n_good
        if n_good < 100 or frac_ok < 0.9 or frac_span < 0.9:
            fail(f"rate {code_rate} channel {c}: {n_good} sent packets "
                 f"decoded of {n_after} after lock, span {span}")
    print(f"[rate {code_rate}] TS: {total_good} sent packets decoded over "
          f"{NCHAN} channels; worst channel fraction {worst:.4f}")

    # Steady state: chunks 1.. (chunk 0 includes first-call costs).
    steady = slice(1, NCHUNKS)
    nsteady = NCHUNKS - 1
    stages = dict.fromkeys(("mf", "demod", "append", "decode", "fetch",
                            "backend"), 0.0)
    for k, name, s, e in marks:
        if k >= 1:
            stages["fetch" if name == "pack" else name] += \
                s.elapsed_time(e) / nsteady
    for k, name, ms in host:
        if k >= 1:
            stages[name] += ms / nsteady
    chunk_s = sum(wall[steady]) / len(wall[steady])
    rate = NCHAN * CHUNK_SAMPLES / chunk_s / 1e6
    print(f"[rate {code_rate}] per-stage ms per chunk (steady state, chunks "
          f"1..{NCHUNKS - 1}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"[rate {code_rate}] chain: {chunk_s * 1e3:.1f} ms per chunk, "
          f"{rate:.1f} Msamples/s ({NCHAN} x 2 Msym/s carriers need "
          f"{NCHAN * 4.0:.0f})")
    if code_rate != "1/2":
        return rx, frames, launches, stages, rate, None

    # The same stream through the pipelined path.
    rp = multi_rx.MultiDvbsReceiver(cfg, NCHAN, chunk_samples=CHUNK_SAMPLES,
                                    device=dev)
    done = []
    try:
        for k in range(NCHUNKS):
            if k == 1:
                done += rp.flush()
                torch.cuda.synchronize()
                t = time.perf_counter()
            done += rp.submit(
                frames[:, k * CHUNK_SAMPLES:(k + 1) * CHUNK_SAMPLES + ra])
        done += rp.flush()
        torch.cuda.synchronize()
        piped_s = (time.perf_counter() - t) / (NCHUNKS - 1)
    finally:
        rp.close()
    piped = [[] for _ in range(NCHAN)]
    for out in done:
        for c in range(NCHAN):
            piped[c] += list(out[c])
    # The decode schedule runs on a fill estimate one chunk older than in
    # process(), so decodes (and TRACK entry) may land a chunk later: hold
    # its output to the same gate, not to byte equality.
    piped_good = 0
    for c in range(NCHAN):
        n_after, n_good, span = check_packets(c, piped[c])
        piped_good += n_good
        if n_good < 100 or n_good < 0.9 * max(n_after, span):
            fail(f"channel {c} (submit): {n_good} sent packets decoded of "
                 f"{n_after} after lock, span {span}")
    piped_rate = NCHAN * CHUNK_SAMPLES / piped_s / 1e6
    print(f"pipelined submit(): {piped_s * 1e3:.1f} ms per chunk, "
          f"{piped_rate:.1f} Msamples/s; {piped_good} sent packets decoded")
    return rx, frames, launches, stages, rate, piped_rate


# ---------------------------------------------------------------- phase 5

def max_sm_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits", "-i", "0"],
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.strip()) * 1e6


def kernel_times(rx, frames, dev, gen):
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_device as vd
    C, n = NCHAN, CHUNK_SAMPLES
    clock = max_sm_clock_hz()
    x = frames[:, :n + rx.readahead]
    xm = mf_prefilter.mf_prefilter(rx.mf_taps, rx._planes[2], x)
    planes = rx._planes.clone()
    demod_ms = cuda_time(lambda: rk.demod(rx.params, rx._sym_consts, planes,
                                          xm), reps=3)
    d_bytes = (n + 1) * C * 8 + n * C * 4 + 2 * rk.NSTATE * C * 4
    d_ops = 110.0 * n * C               # float ops per sample, demod.cu
    chain_ms = n * DEMOD_CHAIN_OPS * DEP_LATENCY_CYCLES / clock * 1e3
    out = {"demod": dict(ms=demod_ms, bound=bound_ms(d_bytes, d_ops),
                         shape=f"C={C} nsamp={n}", chain_bound_ms=chain_ms)}
    # A fleet wide enough to occupy every SM (8192 channels = 256 warps).
    Cw, nw = 8192, 1 << 15
    xw = xm[:, :nw + 1].repeat(Cw // C, 1, 1).contiguous()
    pw = planes.repeat(1, Cw // C).contiguous()
    ms = cuda_time(lambda: rk.demod(rx.params, rx._sym_consts, pw, xw),
                   reps=3)
    out["demod_wide"] = dict(
        ms=ms, bound=bound_ms((nw + 1) * Cw * 8 + nw * Cw * 4, 110.0 * nw
                              * Cw), shape=f"C={Cw} nsamp={nw}",
        chain_bound_ms=nw * DEMOD_CHAIN_OPS * DEP_LATENCY_CYCLES / clock
        * 1e3)
    del xw, pw
    T = rx.deconv.plan.nblocks
    for N, cheap_q, key in ((C * vd.NSYNCS, False, "acs"),
                            (C, True, "acs_track")):
        cs = torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                           generator=gen)
        cost = -torch.randint(0, 40, (T, N), device=dev, dtype=torch.int32,
                              generator=gen)
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)
        ms = cuda_time(lambda: vd.viterbi_acs("1/2", z, z, cs, cost,
                                              cheap_q=cheap_q), reps=3)
        a_bytes = T * N * 16 + 4 * 64 * N * 4
        a_ops = T * N * 64 * 16.0        # ~16 integer ops per state
        out[key] = dict(ms=ms, bound=bound_ms(a_bytes, a_ops,
                                              int32_ops_per_s(clock)),
                        shape=f"N={N} T={T} cheap_q={cheap_q}")
    for k, v in out.items():
        chain = (f", serial chain bound {v['chain_bound_ms']:.3f} ms"
                 if "chain_bound_ms" in v else "")
        print(f"kernel {k:10s} {v['shape']}: {v['ms']:.3f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}){chain}")
    print(f"demod rate: {C * n / out['demod']['ms'] / 1e3:.1f} Msamples/s "
          f"at C={C}, {Cw * nw / out['demod_wide']['ms'] / 1e3:.1f} "
          f"Msamples/s at C={Cw} (max SM clock {clock / 1e6:.0f} MHz)")
    return out


def banked_ops(rate: str, T: int, N: int) -> float:
    """Integer operations the banked ACS function needs for T blocks over
    N lanes, per block and lane (what the function computes, not the
    kernel's own instruction mix):
      * 2 for the block: the rank ncs-1-cs of its coded symbol and its
        cost << RB;
      * 3 per predecessor state (64): its key base m << RB and its
        provided-branch key (base + cost << RB) | ncs, shared by every
        row it feeds;
      * 4 per branch candidate (64 rows x K slots; 7/8 has two coded
        symbols per slot, 8): the plain key base | rank, the test of its
        coded symbol against the block's, the select of the provided
        key, the running min;
      * 11 per row (16 at 7/8): the winner's path shift (hi: shift,
        shift, or; lo: shift, or), its metric key >> RB, the best-state
        key (shift, or), one step each of the best and second-best
        64-way mins, the normalisation; at 7/8 the choice of the uncoded
        symbol of the winning branch (mask, two tests, two selects)."""
    from leansdr_tpu_torch.fec.viterbi_banked import bank_geometry
    geo = bank_geometry(rate)
    per_slot, per_row = (8, 16) if geo.B == 7 else (4, 11)
    return float(T) * N * (2 + 64 * 3 + 64 * geo.K * per_slot
                           + 64 * per_row)


def banked_times(dev, gen):
    """acs_banked at the main path's shapes (64 carriers, chunk 2^18):
    ACQUIRE (64 x nsyncs lanes) and TRACK (64 lanes), at every fleet
    punctured rate, with bounds at the INT32 issue rate."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    clock = max_sm_clock_hz()
    out = []
    for rate in ("3/4", "7/8", "5/6", "4/6"):
        plan = fleet_plan(rate, dev)
        T = plan.nblocks
        ncs = vb.bank_geometry(rate).ncs
        for mode, N in (("acquire", plan.n_lanes), ("track", NCHAN)):
            cs = torch.randint(0, ncs, (T, N), device=dev,
                               dtype=torch.int32, generator=gen)
            cost = -torch.randint(0, 80, (T, N), device=dev,
                                  dtype=torch.int32, generator=gen)
            z = torch.zeros((64, N), dtype=torch.int32, device=dev)
            ms = cuda_time(lambda: vb.viterbi_acs_banked(rate, z, z, z, cs,
                                                         cost), reps=2)
            b, by = bound_ms(T * N * 16 + 6 * 64 * N * 4,
                             banked_ops(rate, T, N), int32_ops_per_s(clock))
            out.append(dict(rate=rate, mode=mode, N=N, T=T, ms=ms,
                            bound_ms=b, bound_by=by))
            print(f"kernel acs_banked {rate} {mode:7s} N={N:4d} T={T}: "
                  f"{ms:.3f} ms, bound {b:.4f} ms ({by}), "
                  f"{T / ms / 1e3:.2f} Mblocks/s per lane")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from leansdr_tpu_torch import device as kdev
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.native import build_lib

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = kdev.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_lib()
    native_s = time.perf_counter() - t0
    print(f"kernel build (nvcc, parallel): {build_s:.1f} s; byte backend "
          f"(g++): {native_s:.1f} s")
    for name, (so, report) in built.items():
        lines = [l.strip() for l in report.splitlines()
                 if "registers" in l or "spill" in l]
        print(f"  {name}: {so.name}: " + " | ".join(lines))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    d_err = 0.0
    d_plain = None
    for predef, rate, nsym, C in ((Predef.QPSK, "1/2", 4, NCHAN),
                                  (Predef.QPSK, "1/2", 4, 8192),
                                  (Predef.PSK8, "2/3", 8, NCHAN)):
        e, p = check_demod(predef, rate, nsym, C, 4096, dev, gen)
        d_err = max(d_err, e)
        if d_plain is None:
            d_plain = p
    a_err, a_plain = check_acs(dev, gen)
    b_err, b_plain, b_plain_n = check_acs_banked(dev, gen)

    rx, frames, launches, stages, rate, piped_rate = main_path(dev, gen)
    times = kernel_times(rx, frames, dev, gen)
    del rx, frames
    punctured = {}
    for code_rate in PUNCTURED:
        _, _, p_launches, p_stages, p_rate, _ = main_path(dev, gen,
                                                          code_rate)
        punctured[code_rate] = dict(launches=p_launches, stages_ms=p_stages,
                                    chain_msamples_per_s=p_rate)
    btimes = banked_times(dev, gen)
    b0 = btimes[0]                      # 3/4 ACQUIRE: the headline shape

    kernels = [
        {"name": "demod", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/demod.cu",
         "replaces": "leansdr_tpu/dsp/receiver_pallas.py:61",
         "launches": launches["demod"], "max_abs_err": d_err,
         "ms": times["demod"]["ms"], "plain_ms": d_plain,
         "bound_ms": times["demod"]["bound"][0],
         "bound_by": times["demod"]["bound"][1], "library_ms": None,
         "shape": times["demod"]["shape"],
         "chain_bound_ms": times["demod"]["chain_bound_ms"],
         "wide_ms": times["demod_wide"]["ms"],
         "wide_shape": times["demod_wide"]["shape"],
         "plain_shape": f"C={NCHAN} nsamp=4096"},
        {"name": "acs", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/acs.cu",
         "replaces": "leansdr_tpu/fec/viterbi_device.py:91",
         "launches": launches["acs"], "max_abs_err": a_err,
         "ms": times["acs"]["ms"], "plain_ms": a_plain,
         "bound_ms": times["acs"]["bound"][0],
         "bound_by": times["acs"]["bound"][1], "library_ms": None,
         "shape": times["acs"]["shape"],
         "track_ms": times["acs_track"]["ms"],
         "track_shape": times["acs_track"]["shape"],
         "plain_shape": "N=256 T=2048 cheap_q=False"},
        {"name": "acs_banked", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/acs_banked.cu",
         "replaces": "leansdr_tpu/fec/viterbi_banked.py:361",
         "launches": sum(p["launches"]["acs_banked"]
                         for p in punctured.values()),
         "launches_by_rate": {r: p["launches"]["acs_banked"]
                              for r, p in punctured.items()},
         "max_abs_err": b_err, "ms": b0["ms"], "plain_ms": b_plain,
         "bound_ms": b0["bound_ms"], "bound_by": b0["bound_by"],
         "library_ms": None,
         "shape": f"rate {b0['rate']} N={b0['N']} T={b0['T']}",
         "shapes": btimes,
         "plain_shape": f"rate 3/4 N={b_plain_n} T=1024"},
    ]
    print(json.dumps({"stages_ms": stages, "chain_msamples_per_s": rate,
                      "pipelined_msamples_per_s": piped_rate,
                      "punctured": punctured, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
