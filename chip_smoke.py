#!/usr/bin/env python3
"""Smoke test of leansdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from leansdr_tpu_torch/csrc (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the fleet receiver's main path at full width — 64 QPSK carriers at
2 Msym/s sampled at 4 Msps, chunk_samples = 2**18, Viterbi on — at code
rate 1/2 (the rate-1/2 ACS kernel) and at the punctured rates 3/4 and 7/8
(the banked ACS kernel), each sequentially and with the time-segmented
demod (segments=8), and the single-carrier receiver of leandvb on five
streams (the CLI defaults, the same with --segments 8, --resample on the
complex FIR kernel, --hq at 1/2 and 3/4), from DVB-S stimulus the port
modulates itself, and checks that every carrier locks and decodes the
TS packets that were sent.

Phases (any failure exits non-zero):
  1. card name and power limit, versions, kernel build time;
  2. demod kernel == demod_ref (QPSK at C=64 and C=8192, 8PSK at C=64;
     4096 samples: the plain version costs one launch per op per sample).
     Tolerance: valid exactly on every sample, symbol and cost exactly on
     every valid sample, float state within max(1e-3, 1e-4*|v|) (the CPU
     tests' bar; the kernel and its plain version round alike, so 0 is
     expected);
  3. ACS kernel == viterbi_acs_ref bit for bit (ties forced, from zero
     and from a live state; T=2048 at the fleet's N=256 ACQUIRE lanes
     with and without cheap_q and its N=64 TRACK lanes with cheap_q;
     T=128 at the single carrier's N=4 replica lanes without cheap_q);
     banked ACS kernel == viterbi_acs_banked_ref bit for bit at 4/6,
     3/4, 5/6 and 7/8 (ties forced, from zero and from a live state;
     T=1024 at each rate's fleet ACQUIRE lanes, at TRACK's 64 and at
     N=200; T=128 at the single carrier's nsyncs lanes, 8 to 16);
     cfir == cfir_ref and fir == fir_ref bit for bit (nt 21, 79, 2048;
     lengths off the tile; from a zero head and mid-stream); fft4096
     within max|dy| / max|y| < 2e-5 of fft4096_ref and of torch.fft.fft
     at B=8 and 1024 (the sums run in other orders); torch.argmax takes
     the first maximum on the card, as the segmented demod needs;
  4. the main path through MultiDvbsReceiver.process, with the kernels'
     launch counters zeroed just before and read just after, and
     per-stage times from CUDA events; at rate 1/2 then the same stream
     through the pipelined submit()/flush() path (device->host copy and
     byte backend on threads), held to the same TS gate; then with
     segments=8 (seg_holdoff=2, 8 chunks: 5 timed segmented chunks; the
     demod's pass 1, pass 2 and the engine's own relabel/splice ops
     timed apart), the two demod launches of its last chunk against
     demod_ref bit for bit on their first 1024 samples, and the rate-1/2
     chain at segments 1, 2, 4, 8 and 16; then 64 carriers at 3/4 and at
     7/8, sequential and segments=8, each run with its own zeroed
     counters; then the single-carrier receiver (leandvb's DvbsReceiver,
     in its 2^17-sample reads) on five streams, each with its own zeroed
     counters: rtl_sdr u8 at 2.4 Msps with a birdie (the CLI defaults:
     notch, hard decisions), the same bytes with --segments 8, a 10 Msps
     s16 333 ksym/s carrier through --resample (cfir), and --hq at 1/2
     and 3/4 on 4 Msps f32 (the ACS kernels); each must lock and decode
     >= 90% of the packets sent after lock; per-stage times, input
     Msamples/s and x real time; after each stream, the inputs of its
     first launch of every kernel and of one launch mid-stream (a live
     state; with --segments both passes of one read) go through the
     kernel and its plain version again, equal bit for bit (the demod on
     the first 1024 samples of the read: its plain version costs ~3 ms
     per sample on the card);
  5. kernel times at the main path's shapes (the demod also at the
     segmented launches' shapes), bounds, one `kernels` line (cfir/fir
     beside one conv1d computing the same FIR, TF32 off; fft4096 beside
     one torch.fft.fft);
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
# The segmented fleet (slice 2): SEG_HOLDOFF sequential chunks, one that
# builds the segment states, then SEG_CHUNKS - SEG_HOLDOFF - 1 timed.
SEG_CHUNKS = 8
SEG_HOLDOFF = 2
SEG_SWEEP = (1, 2, 4, 8, 16)     # rate-1/2 chain at these segment counts
FFT_BAR = 2e-5                   # max|dy| / max|y|: tests/test_fft_fir.py
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
# The single-carrier paths' launches held against the plain versions:
# the first launch of each kernel and this one (a live, mid-stream
# state); the demod on this many samples of its read.
SC_LIVE_LAUNCH = {"demod": 20, "cfir": 20, "acs": 4000, "acs_banked": 4000}
SC_DEMOD_CHECK = 1024


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
    out = []
    for N, cheap_q, T in ((NCHAN * vd.NSYNCS, False, 2048),
                          (NCHAN * vd.NSYNCS, True, 2048),
                          (NCHAN, True, 2048),
                          (sc_lanes("1/2", dev), False, 128)):
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


def sc_lanes(rate, dev):
    """The single-carrier decoder's replica lanes (nsyncs) at `rate`."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec.viterbi import ViterbiSyncDevice
    return ViterbiSyncDevice(make_dvbs2_constellation(Predef.QPSK, rate),
                             rate, device=dev).nsyncs


def fleet_plan(rate, dev):
    """The ACQUIRE ViterbiPlan of the 64-carrier main path at `rate`."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec import viterbi_device as vd
    return vd.MultiViterbiSync(make_dvbs2_constellation(Predef.QPSK, rate),
                               rate, NCHAN, CHUNK_SAMPLES, 2.0,
                               device=dev).plan


def check_acs_banked(dev, gen):
    """acs_banked == viterbi_acs_banked_ref bit for bit at every fleet
    punctured rate, coarse costs forcing metric ties: T=1024 at the fleet
    main path's lane counts (the rate's ACQUIRE lanes, 64 carriers x
    nsyncs, and TRACK's 64) and at N=200 (not a multiple of 32); T=128
    (one single-carrier chunk) at the single carrier's nsyncs lanes;
    round 0 from zero planes, round 1 from the kernel's end state.
    Returns (max |diff|, plain ms at 3/4 ACQUIRE round 0, its N)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    err, plain = 0.0, None
    for rate in vb.FLEET_RATES:
        ncs = make_trellis(rate).ncs
        n_acq = fleet_plan(rate, dev).n_lanes
        for N, T in ((n_acq, 1024), (NCHAN, 1024), (200, 1024),
                     (sc_lanes(rate, dev), 128)):
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


def check_fir(dev, gen):
    """cfir == cfir_ref and fir == fir_ref bit for bit (both built with
    --fmad=false) at nt in {21, 79, 2048}, at lengths that are not
    multiples of the kernel's 256-sample tile, from a stream head (zeros
    before it) and from mid-stream; fir on 128 rows. Returns (max |diff|,
    plain cfir ms and plain fir ms at nt=79, n=2^17+85, the --resample
    path's shape)."""
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    err, plain = 0.0, {}
    for nt, n in ((21, 50001), (79, (1 << 17) + 85), (2048, 9000)):
        for head in (True, False):
            x = 40 * torch.randn((2, n), device=dev, generator=gen)
            if head:
                x[:, :nt] = 0
            w = torch.randn((2, nt), device=dev, generator=gen) / nt ** 0.5
            k = fk.cfir(x, w[0].contiguous(), w[1].contiguous())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fk.cfir_ref(x, w[0], w[1])
            torch.cuda.synchronize()
            plain["cfir", nt] = (time.perf_counter() - t0) * 1e3
            if not torch.equal(k, r):
                fail(f"cfir nt={nt} n={n} head={head}: "
                     f"{int((k != r).sum())} outputs differ")
            err = max(err, float((k - r).abs().max()))
        xr = 40 * torch.randn((128, n), device=dev, generator=gen)
        tr = torch.randn(nt, device=dev, generator=gen) / nt ** 0.5
        k = fk.fir(xr, tr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fk.fir_ref(xr, tr)
        torch.cuda.synchronize()
        plain["fir", nt] = (time.perf_counter() - t0) * 1e3
        if not torch.equal(k, r):
            fail(f"fir nt={nt} n={n}: {int((k != r).sum())} outputs differ")
        err = max(err, float((k - r).abs().max()))
        print(f"cfir/fir nt={nt} n={n}: bit-equal (head and mid-stream), "
              f"plain {plain['cfir', nt]:.0f} / {plain['fir', nt]:.0f} ms")
    return err, plain["cfir", 79], plain["fir", 79]


def check_fft(dev, gen):
    """fft4096 against fft4096_ref (TF32 off) and torch.fft.fft at B=8 and
    B=1024, unit-variance planes: max|dy| / max|y| < FFT_BAR (the sums
    run in other orders, so not bit for bit). Returns (max |dy| against
    the plain version, the largest relative error against each)."""
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    err, rel_plain, rel_lib = 0.0, 0.0, 0.0
    for B in (8, 1024):
        xr, xi = (torch.randn((B, ffk.N), device=dev, generator=gen)
                  for _ in range(2))
        y = torch.complex(*ffk.fft4096(xr, xi))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = torch.complex(*ffk.fft4096_ref(xr, xi))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lib = torch.fft.fft(torch.complex(xr, xi))
        e_plain = float((y - r).abs().max() / r.abs().max())
        e_lib = float((y - lib).abs().max() / lib.abs().max())
        print(f"fft4096 B={B}: max|dy|/max|y| {e_plain:.3g} against "
              f"fft4096_ref, {e_lib:.3g} against torch.fft.fft, plain "
              f"{plain_ms:.1f} ms")
        if not (e_plain < FFT_BAR and e_lib < FFT_BAR):
            fail(f"fft4096 B={B}: {e_plain:.3g} / {e_lib:.3g} >= {FFT_BAR}")
        err = max(err, float((y - r).abs().max()))
        rel_plain, rel_lib = max(rel_plain, e_plain), max(rel_lib, e_lib)
    return err, rel_plain, rel_lib


def check_first_argmax(dev, gen):
    """The segmented demod's rotation estimate and handover cut take the
    FIRST maximum of torch.argmax (the first agreeing row, the smallest
    rotation on ties), as jnp.argmax does: held on the card on the
    engine's shapes, with many ties."""
    for shape, hi in (((127, 8 * NCHAN), 2), ((4, 8 * NCHAN), 3)):
        a = torch.randint(0, hi, shape, device=dev, dtype=torch.int32,
                          generator=gen)
        got = torch.argmax(a, dim=0).cpu().numpy()
        want = np.argmax(a.cpu().numpy(), axis=0)
        if not (got == want).all():
            fail(f"torch.argmax on the card does not take the first "
                 f"maximum ({int((got != want).sum())} of {shape[1]})")
    print("argmax on the card takes the first maximum (as jnp.argmax)")


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


def fleet_rx(dev, code_rate, **seg):
    """The 64-carrier fleet receiver of the main path at `code_rate`
    (seg: MultiDvbsReceiver's segments, seg_warmup, seg_holdoff)."""
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate=code_rate, fastlock=True,
                   float_scale=75, exact_lut=False, viterbi=True,
                   sampler="rrc")
    return multi_rx.MultiDvbsReceiver(cfg, NCHAN, chunk_samples=CHUNK_SAMPLES,
                                      device=dev, **seg)


def fleet_frames(dev, gen, code_rate):
    """SEG_CHUNKS chunks of fleet_stimulus at `code_rate`, scaled by the
    float_scale (the device path's contract); the S=1 runs read the first
    NCHUNKS of them."""
    ra = fleet_rx(dev, code_rate).readahead
    t0 = time.perf_counter()
    frames = fleet_stimulus(dev, gen, SEG_CHUNKS * CHUNK_SAMPLES + ra,
                            code_rate) * 75.0
    torch.cuda.synchronize()
    print(f"[rate {code_rate}] stimulus: {NCHAN} x {frames.shape[1]} "
          f"samples in {time.perf_counter() - t0:.1f} s")
    return frames


def fleet_run(rx, frames, nchunks, tag, steady_from, capture=None):
    """`nchunks` chunks through rx.process() with every kernel's launch
    count zeroed just before and read just after; per-stage CUDA events
    (host clocks for the host stages); the lock and TS gate. Steady state
    is chunks steady_from.. . capture(k) -> True records the inputs of
    chunk k's demod launches. Returns dict(launches, stages, rate in
    Msamples/s, chunk_ms, captured)."""
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_device as vd
    from leansdr_tpu_torch.pipelines import multi_rx

    chunk = [0]
    marks = []                                   # (chunk, stage, s, e)
    host = []                                    # (chunk, stage, ms)
    captured = []
    S = rx.segments

    def timed(name, fn):
        def wrapper(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            marks.append((chunk[0], name(a) if callable(name) else name,
                          s, e))
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

    calls = {}                                   # chunk -> demod calls

    def demod_stage(a):
        k = chunk[0]
        calls[k] = calls.get(k, 0) + 1
        if S == 1 or k < rx.seg_holdoff:
            return "demod"
        return "pass1" if calls[k] == 1 else "pass2"

    demod = rk.demod

    def recorded(*a, **kw):
        if capture is not None and capture(chunk[0]):
            captured.append([v.clone() if torch.is_tensor(v) else v
                             for v in a])
        return demod(*a, **kw)

    counted = kernel_wrappers()
    patches = [(mf_prefilter, "mf_prefilter", timed("mf", mf_prefilter.
                                                   mf_prefilter)),
               (rk, "demod", timed(demod_stage, recorded)),
               (multi_rx, "_demod_segmented", timed(
                   "segmented", multi_rx._demod_segmented)),
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

    ra = rx.readahead
    pkts = [[] for _ in range(NCHAN)]
    wall = []
    for fn in counted.values():
        fn.launches = 0
    try:
        for k in range(nchunks):
            chunk[0] = k
            x = frames[:, k * CHUNK_SAMPLES:(k + 1) * CHUNK_SAMPLES + ra]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = rx.process(x)
            wall.append(time.perf_counter() - t)
            for c in range(NCHAN):
                pkts[c] += list(out[c])
    finally:
        launches = {k: fn.launches for k, fn in counted.items()}
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    torch.cuda.synchronize()

    acs_key = "acs" if rx.rate == "1/2" else "acs_banked"
    print(f"[{tag}] {nchunks} chunks of {NCHAN} x {CHUNK_SAMPLES}; launches "
          f"{launches}; TRACK={rx.deconv.track}")
    if launches["demod"] < nchunks or launches[acs_key] < 1:
        fail(f"{tag} did not run through the kernels: {launches}")
    locks = rx.locks
    if not all(locks):
        fail(f"{tag}: channels not locked: "
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
            fail(f"{tag} channel {c}: {n_good} sent packets decoded of "
                 f"{n_after} after lock, span {span}")
    print(f"[{tag}] TS: {total_good} sent packets decoded over {NCHAN} "
          f"channels; worst channel fraction {worst:.4f}")

    nsteady = nchunks - steady_from
    stages = dict.fromkeys(
        ("mf", "demod", "append", "decode", "fetch", "backend") if S == 1
        else ("mf", "pass1", "pass2", "splice", "segmented", "append",
              "decode", "fetch", "backend"), 0.0)
    for k, name, s, e in marks:
        if k >= steady_from:
            stages["fetch" if name == "pack" else name] += \
                s.elapsed_time(e) / nsteady
    for k, name, ms in host:
        if k >= steady_from:
            stages[name] += ms / nsteady
    if S > 1:
        # The segmented demod's own ops (window stacking, relabel,
        # handover cuts, derotation, splice): its span less its matched
        # filters and demod passes.
        stages["splice"] = stages["segmented"] - (
            stages["mf"] + stages["pass1"] + stages["pass2"])
    chunk_s = sum(wall[steady_from:]) / nsteady
    rate = NCHAN * CHUNK_SAMPLES / chunk_s / 1e6
    print(f"[{tag}] per-stage ms per chunk (steady state, chunks "
          f"{steady_from}..{nchunks - 1}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"[{tag}] chain: {chunk_s * 1e3:.1f} ms per chunk, {rate:.1f} "
          f"Msamples/s ({NCHAN} x 2 Msym/s carriers need "
          f"{NCHAN * 4.0:.0f})")
    return dict(launches=launches, stages=stages, rate=rate,
                chunk_ms=chunk_s * 1e3, captured=captured)


def main_path(dev, gen, frames, code_rate="1/2"):
    """The fleet at `code_rate`, segments=1: NCHUNKS chunks through
    process(); at rate 1/2 also the pipelined submit() path."""
    rx = fleet_rx(dev, code_rate)
    run = fleet_run(rx, frames, NCHUNKS, f"rate {code_rate}", 1)
    if code_rate != "1/2":
        return rx, run, None

    # The same stream through the pipelined path.
    ra = rx.readahead
    rp = fleet_rx(dev, code_rate)
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
    return rx, run, piped_rate


def segmented_path(dev, frames, code_rate, S, capture=False):
    """The fleet with segments=S (seg_holdoff=SEG_HOLDOFF): SEG_CHUNKS
    chunks, the first SEG_HOLDOFF sequential, then segmented; steady
    state from the second segmented chunk on (the first builds the
    segment states). With capture, the inputs of both demod launches of
    the last chunk are kept."""
    rx = fleet_rx(dev, code_rate, segments=S, seg_holdoff=SEG_HOLDOFF)
    return fleet_run(rx, frames, SEG_CHUNKS, f"rate {code_rate} S={S}",
                     SEG_HOLDOFF + 1,
                     (lambda k: k == SEG_CHUNKS - 1) if capture else None)


def seg_plain_checks(captured, params, sym_consts):
    """The captured demod launches of a segmented chunk (pass 1 and pass
    2) through the kernel and demod_ref on their first SC_DEMOD_CHECK
    samples: outputs equal bit for bit. Returns [(lanes, plain ms)]."""
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    done = []
    for a in captured:
        planes = a[2]
        x = a[3][:, :SC_DEMOD_CHECK + 1].contiguous()
        k = rk.demod(params, sym_consts, planes, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = rk.demod_ref(params, sym_consts, planes, x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for i, (u, w) in enumerate(zip(k, r)):
            if not torch.equal(u, w):
                fail(f"segmented demod launch at {x.shape[0]} lanes: output "
                     f"{i} differs from demod_ref in {int((u != w).sum())} "
                     "entries")
        done.append((x.shape[0], plain_ms))
    return done


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its name in the kernels line
    (their `launches` counters)."""
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    return {"demod": rk.demod, "acs": vd.viterbi_acs,
            "acs_banked": vb.viterbi_acs_banked, "cfir": fk.cfir,
            "fir": fk.fir, "fft4096": ffk.fft4096}


# The single-carrier paths (leandvb's receiver): name, RxConfig fields as
# the CLI's flags set them, input format, seconds of signal, the
# stimulus's resampling of the modulator's 2 samples per symbol (up,
# down, pick), carrier offset (Hz), Es/N0 (dB) and a birdie tone (Hz, or
# None). pick=True upsamples by `up` and keeps every `down`-th sample
# from the 3rd (a 0.3-sample delay at 2.4 Msps): a front end whose
# filter passes the DVB-S excess band, which folds back in-band. A
# brick-wall filter at 1.2 MHz (resample_poly(6, 5)), closer to a real
# rtl_sdr front end, cuts that band instead, and the JAX receiver then
# reaches MER ~10 dB on a clean carrier and does not lock
# (tools/frontend_mer.py; ROADMAP queue 1 item 24), so this stream's
# lock gate is easier than a real front end's.
SC_PATHS = (
    # rtl_sdr u8 at 2.4 Msps, 2 Msym/s, rate 1/2: the CLI's defaults
    # (anf=1, linear sampler, hard decisions); 2^23 samples.
    ("canonical", dict(Fs=2.4e6, Fm=2e6, rate="1/2"), "u8", 2 ** 23 / 2.4e6,
     (6, 10, True), 20e3, 20.0, 150e3),
    # The same stream through `leandvb --segments 8` (the time-segmented
    # demod over 8 lanes; the first seg_holdoff = 8 reads sequential).
    ("canonical S=8", dict(Fs=2.4e6, Fm=2e6, rate="1/2", segments=8), "u8",
     2 ** 23 / 2.4e6, (6, 10, True), 20e3, 20.0, 150e3),
    # PlutoSDR-style s16 at 10 Msps of a 333 ksym/s QO-100 DATV carrier:
    # --s16 -f 10e6 --sr 333e3 --resample (decim 7, 79 taps).
    ("resample", dict(Fs=10e6, Fm=333e3, rate="1/2", resample=True), "s16",
     2.0, (3003, 200, False), 15e3, 16.0, None),
    # --hq at 4 Msps f32 (--float-scale 75), rates 1/2 and 3/4.
    ("hq 1/2", dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, viterbi=True,
                    sampler="rrc", float_scale=75.0), "f32", 1.0,
     (3, 3, True), 20e3, 10.0, None),
    ("hq 3/4", dict(Fs=4e6, Fm=2e6, rate="3/4", fastlock=True, viterbi=True,
                    sampler="rrc", float_scale=75.0), "f32", 1.0,
     (3, 3, True), 20e3, 12.0, None),
)


def sc_stimulus(rate, fs, seconds, updown, f_off, esn0_db, birdie, fmt,
                rng):
    """Wire bytes of `seconds` of one DVB-S carrier at rate `rate`: the
    port's modulation of numbered TS packets resampled from 2 samples per
    symbol to fs (see SC_PATHS for `pick`), shifted by f_off Hz, with
    AWGN at Es/N0, an optional CW birdie 20 dB below the carrier's power
    (16 dB above the carrier in its 4096-point FFT bin), quantized to fmt
    (u8 ~ 30 LSB rms, s16 ~ 3000 LSB rms, f32 unit rms for
    --float-scale 75). Returns (bytes, packets sent)."""
    from scipy.signal import resample_poly
    from leansdr_tpu_torch.fec.convenc import FEC_SPECS
    from leansdr_tpu_torch.fec.viterbi_banked import fleet_rate
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    up, down, pick = updown
    n = int(round(seconds * fs))
    bits_in, bits_out = FEC_SPECS[fleet_rate(rate)]
    nsym = n * down / (2 * up)
    npkt = int(nsym * 2 * bits_in / bits_out / 1632) + 16
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate=rate, interp=2))
    z = iq[:, 0] + 1j * iq[:, 1]
    z = (resample_poly(z, up, 1)[3::down] if pick
         else resample_poly(z, up, down))
    if len(z) < n:
        fail(f"stimulus: {len(z)} samples < {n}")
    z = z[:n]
    t = np.arange(n)
    ps = float(np.mean(np.abs(z) ** 2))
    # Es/N0 = ps * (samples per symbol) / (complex noise power per sample)
    sigma = np.sqrt(ps * (2 * up / down) / 10 ** (esn0_db / 10) / 2)
    z = z * np.exp(2j * np.pi * f_off / fs * t)
    z = z + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if birdie is not None:
        z = z + np.sqrt(0.01 * ps) * np.exp(2j * np.pi * birdie / fs * t)
    rms = float(np.sqrt(np.mean(np.abs(z) ** 2) / 2))
    x = np.stack([z.real, z.imag], -1).reshape(-1)
    if fmt == "u8":
        return np.clip(np.round(x * (30 / rms) + 128), 0, 255).astype(
            np.uint8).tobytes(), npkt
    if fmt == "s16":
        return np.clip(np.round(x * (3000 / rms)), -32768, 32767).astype(
            np.int16).tobytes(), npkt
    return (x / rms).astype(np.float32).tobytes(), npkt


def sc_plain_checks(name, inputs):
    """The captured inputs of a single-carrier path's kernel launches
    (kernel -> [(call index, args, kwargs)]) through the kernel and its
    plain version: every output equal bit for bit (torch.equal). The
    demod reads the first SC_DEMOD_CHECK samples of its read. Returns
    [(kernel, call index, shape, plain ms)]."""
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    pairs = {"demod": (rk.demod, rk.demod_ref),
             "acs": (vd.viterbi_acs, vd.viterbi_acs_ref),
             "acs_banked": (vb.viterbi_acs_banked, vb.viterbi_acs_banked_ref),
             "cfir": (fk.cfir, fk.cfir_ref)}
    done = []
    for key, calls in inputs.items():
        kern, ref = pairs[key]
        for n, a, kw in calls:
            if key == "demod":
                a = a[:3] + [a[3][:, :SC_DEMOD_CHECK + 1].contiguous()]
            k = kern(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = ref(*a, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            k, r = (k, r) if isinstance(k, tuple) else ((k,), (r,))
            for i, (u, w) in enumerate(zip(k, r)):
                if not torch.equal(u, w):
                    fail(f"{name}: {key} launch {n}: output {i} differs from "
                         f"the plain version in {int((u != w).sum())} "
                         "entries")
            shape = " ".join(f"{list(v.shape)}" for v in a
                             if torch.is_tensor(v))
            done.append((key, n, shape, plain_ms))
    print(f"[{name}] kernels == plain versions on the path's inputs: "
          + "; ".join(f"{k} launch {n} {sh} (plain {ms:.0f} ms)"
                      for k, n, sh, ms in done))
    return done


def single_carrier(dev, rng, stimuli, name, fields, fmt, seconds, updown,
                   f_off, esn0_db, birdie):
    """One single-carrier path: the wire stream through DvbsReceiver in
    leandvb's 2^17-sample reads (read_iq -> process), with every kernel's
    launch count zeroed just before and read just after, device stages
    timed with CUDA events and host stages with the host clock; then the
    inputs of chosen launches against the plain versions
    (sc_plain_checks). Paths with the same stimulus parameters read the
    same bytes (`stimuli` keeps them)."""
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_tpu_torch.util.iofmt import read_iq

    cfg = RxConfig(anf=1, exact_lut=False, **fields)   # leandvb's defaults
    t0 = time.perf_counter()
    key = (cfg.rate, cfg.Fs, seconds, updown, f_off, esn0_db, birdie, fmt)
    if key not in stimuli:
        stimuli[key] = sc_stimulus(*key, rng)
    raw, npkt = stimuli[key]
    print(f"[{name}] stimulus: {len(raw)} bytes {fmt} at {cfg.Fs / 1e6:g} "
          f"Msps ({seconds:.3f} s of signal) in "
          f"{time.perf_counter() - t0:.1f} s")
    rx = DvbsReceiver(cfg, device=dev)

    events, host = [], {}

    def timed(key, fn):
        def wrapper(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events.append((key, s, e))
            return out
        return wrapper

    def hosttimed(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            host[key] = host.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    seen, inputs = {}, {}

    def captured(key, fn):
        # A segmented read launches the demod twice (pass 1, pass 2): the
        # mid-stream check takes both.
        live = (SC_LIVE_LAUNCH[key],) + (
            (SC_LIVE_LAUNCH[key] + 1,) if key == "demod"
            and cfg.segments > 1 else ())

        def wrapper(*a, **kw):
            n = seen.get(key, 0)
            seen[key] = n + 1
            if n in (0,) + live:
                inputs.setdefault(key, []).append(
                    (n, [v.clone() if torch.is_tensor(v) else v for v in a],
                     kw))
            return fn(*a, **kw)
        return wrapper

    kernels = {"demod": (rk, "demod"), "acs": (vd, "viterbi_acs"),
               "acs_banked": (vb, "viterbi_acs_banked"),
               "cfir": (fk, "cfir")}
    # The wrappers (their counters) before the timing patches.
    counted = kernel_wrappers()
    patches = [(mf_prefilter, "mf_prefilter",
                timed("mf", mf_prefilter.mf_prefilter)),
               (multi_rx, "_demod_segmented",
                timed("segmented", multi_rx._demod_segmented))]
    patches += [(m, a, timed(k, captured(k, getattr(m, a))))
                for k, (m, a) in kernels.items()]
    for attr in ("notch", "resampler", "deconv"):
        blk = getattr(rx, attr)
        if blk is not None:
            patches.append((blk, "process", hosttimed(attr, blk.process)))
    patches.append((rx, "_byte_stages", hosttimed("bytes", rx._byte_stages)))
    saved = [(obj, a, getattr(obj, a)) for obj, a, _ in patches]
    for obj, a, fn in patches:
        setattr(obj, a, fn)
    itemsize = {"u8": 2, "s16": 4, "f32": 8}[fmt]
    step = (1 << 17) * itemsize
    ts = []
    for fn in counted.values():
        fn.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for o in range(0, len(raw), step):
            t = time.perf_counter()
            iq = read_iq(raw[o:o + step], fmt)
            host["read"] = host.get("read", 0.0) + \
                (time.perf_counter() - t) * 1e3
            ts.append(rx.process(iq))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        launches = {k: fn.launches for k, fn in counted.items()}
        for obj, a, fn in saved:
            setattr(obj, a, fn)
    device = {}
    for key, s, e in events:
        device[key] = device.get(key, 0.0) + s.elapsed_time(e)
    pkts = np.concatenate(ts) if ts else np.empty((0, 188), np.uint8)
    n_after, n_good, span = check_packets(0, list(pkts))
    need = ["demod"] + (["cfir"] if cfg.resample else []) + (
        ["acs" if cfg.rate == "1/2" else "acs_banked"] if cfg.viterbi
        else [])
    print(f"[{name}] launches {launches}; lock {rx.lock}, locktime "
          f"{rx.locktime}, VBER {rx.vber:.2e}, notch slots "
          f"{rx.notch.b.slot_i.tolist()}; {n_good} sent packets of "
          f"{n_after} after lock (span {span}; {npkt} sent)")
    if any(launches[k] < 1 for k in need):
        fail(f"{name}: the path did not run through {need}: {launches}")
    if not rx.lock or n_good < 100 or n_good < 0.9 * max(n_after, span):
        fail(f"{name}: {n_good} sent packets decoded of {n_after} after "
             f"lock, span {span}, lock {rx.lock}")
    short = [k for k in need if len(inputs.get(k, ())) < 2 + (
        k == "demod" and cfg.segments > 1)]
    if short:
        fail(f"{name}: no mid-stream launch of {short} to hold against the "
             f"plain version ({seen})")
    checks = sc_plain_checks(name, inputs)
    nsamp = len(raw) // itemsize
    xrt = nsamp / cfg.Fs / wall
    print(f"[{name}] wall {wall:.3f} s for {nsamp} samples: "
          f"{nsamp / wall / 1e6:.3f} Msamples/s in, {xrt:.3f} x real time; "
          "device ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    device.items()) +
          "; host ms: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    return dict(path=name, fmt=fmt, fs=cfg.Fs, samples=nsamp, wall_s=wall,
                msamples_per_s=nsamp / wall / 1e6, x_real_time=xrt,
                device_ms=device, host_ms=host, launches=launches,
                packets_good=int(n_good), packets_after_lock=int(n_after),
                slots=rx.notch.b.slot_i.tolist(),
                plain_checks=[dict(kernel=k, launch=n, shapes=sh,
                                   plain_ms=ms) for k, n, sh, ms in checks])


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


def fir_times(dev, gen):
    """cfir at the --resample path's shape (one 2^17-sample read plus the
    filter history, 79 taps) and fir at the bench baseline's shape (64
    channels' re/im rows, 2^18 samples, 65 RRC taps,
    tools/bench_kernels.py:82-107), with bounds (bytes: input and output
    once; operations: 4 multiplies and 4 adds per complex tap, 1 and 1
    per real tap) and the library yardstick: one conv1d computing the
    same FIR (TF32 off), zero-padded for causality."""
    import torch.nn.functional as F
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    nt, n = 79, (1 << 17) + 85
    x = 40 * torch.randn((2, n), device=dev, generator=gen)
    tr, ti = (torch.randn(nt, device=dev, generator=gen) for _ in range(2))
    ms = cuda_time(lambda: fk.cfir(x, tr, ti), reps=50)
    # conv1d is a cross-correlation: flip the taps. Output channel 0 =
    # re (tr*xr - ti*xi), 1 = im (ti*xr + tr*xi).
    w = torch.stack([torch.stack([tr, -ti]), torch.stack([ti, tr])]).flip(-1)
    xp = F.pad(x, (nt - 1, 0))[None]
    lib = F.conv1d(xp, w)[0]
    ref = fk.cfir(x, tr, ti)
    lib_err = float((lib - ref).abs().max())
    lib_ms = cuda_time(lambda: F.conv1d(xp, w), reps=50)
    out["cfir"] = dict(ms=ms, library_ms=lib_ms, lib_err=lib_err,
                       bound=bound_ms(4 * n * 4 + 2 * nt * 4, 8.0 * nt * n),
                       shape=f"n={n} nt={nt}")
    R, n, nt = 128, 1 << 18, 65
    x = torch.randn((R, n), device=dev, generator=gen)
    taps = torch.randn(nt, device=dev, generator=gen)
    ms = cuda_time(lambda: fk.fir(x, taps), reps=20)
    xp = F.pad(x, (nt - 1, 0))[:, None]
    wf = taps.flip(0).view(1, 1, -1)
    lib_err = float((F.conv1d(xp, wf)[:, 0] - fk.fir(x, taps)).abs().max())
    lib_ms = cuda_time(lambda: F.conv1d(xp, wf), reps=20)
    out["fir"] = dict(ms=ms, library_ms=lib_ms, lib_err=lib_err,
                      bound=bound_ms(2 * R * n * 4 + nt * 4, 2.0 * nt * R * n),
                      shape=f"R={R} n={n} nt={nt}")
    for k, v in out.items():
        print(f"kernel {k:10s} {v['shape']}: {v['ms']:.4f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}); conv1d "
              f"{v['library_ms']:.4f} ms (max |diff| {v['lib_err']:.3g})")
    return out


def seg_demod_times(captured, params, sym_consts, clock):
    """The demod kernel at the segmented fleet's launch shapes (pass 1 and
    pass 2 of a 64-carrier S=8 chunk, from the captured inputs)."""
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    out = []
    for a in captured:
        planes, x = a[2], a[3]
        C, n1, _ = x.shape
        n = n1 - 1
        ms = cuda_time(lambda: rk.demod(params, sym_consts, planes, x),
                       reps=3)
        b, by = bound_ms(n1 * C * 8 + n * C * 4 + 2 * rk.NSTATE * C * 4,
                         110.0 * n * C)
        chain = n * DEMOD_CHAIN_OPS * DEP_LATENCY_CYCLES / clock * 1e3
        out.append(dict(shape=f"C={C} nsamp={n}", ms=ms, bound_ms=b,
                        bound_by=by, chain_bound_ms=chain))
        print(f"kernel demod     C={C} nsamp={n} (segmented): {ms:.3f} ms, "
              f"bound {b:.4f} ms ({by}), serial chain bound {chain:.3f} ms")
    return out


def fft_times(dev, gen):
    """fft4096 at B=1024 beside its plain version and one torch.fft.fft
    (cuFFT) over the same frames as complex64. Bound: 16 bytes per point
    (two planes in, two out) over the HBM rate against 5 N log2 N
    operations per frame at the float rate."""
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    B, N = 1024, ffk.N
    xr, xi = (torch.randn((B, N), device=dev, generator=gen)
              for _ in range(2))
    xc = torch.complex(xr, xi)
    ms = cuda_time(lambda: ffk.fft4096(xr, xi), reps=50)
    plain = cuda_time(lambda: ffk.fft4096_ref(xr, xi), reps=10)
    lib = cuda_time(lambda: torch.fft.fft(xc), reps=50)
    b, by = bound_ms(16.0 * B * N, 5.0 * N * np.log2(N) * B)
    print(f"kernel fft4096    B={B}: {ms:.4f} ms, bound {b:.4f} ms ({by}); "
          f"plain {plain:.4f} ms; torch.fft.fft {lib:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                bound_by=by, shape=f"B={B}")


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
    f_err, f_plain_c, f_plain_r = check_fir(dev, gen)

    fft_err, fft_rel_plain, fft_rel_lib = check_fft(dev, gen)
    check_first_argmax(dev, gen)

    # Phase 4: the fleet at each rate, sequential (segments=1) and
    # segmented (segments=8), on one stimulus per rate; at rate 1/2 also
    # the segment sweep and the segmented launches against demod_ref.
    clock = max_sm_clock_hz()
    frames = fleet_frames(dev, gen, "1/2")
    rx, run, piped_rate = main_path(dev, gen, frames)
    launches, stages, rate = run["launches"], run["stages"], run["rate"]
    times = kernel_times(rx, frames, dev, gen)
    params, sym_consts = rx.params, rx._sym_consts
    del rx
    seg = {"1/2": segmented_path(dev, frames, "1/2", 8, capture=True)}
    captured = seg["1/2"].pop("captured")
    seg_checks = seg_plain_checks(captured, params, sym_consts)
    print("[rate 1/2 S=8] demod launches of chunk "
          f"{SEG_CHUNKS - 1} == demod_ref on {SC_DEMOD_CHECK} samples: "
          + "; ".join(f"{c} lanes (plain {ms:.0f} ms)"
                      for c, ms in seg_checks))
    seg_times = seg_demod_times(captured, params, sym_consts, clock)
    del captured
    sweep = {}
    for S in SEG_SWEEP:
        r = seg["1/2"] if S == 8 else segmented_path(dev, frames, "1/2", S)
        r.pop("captured", None)
        sweep[S] = r
    print("rate-1/2 chain by segments: " + ", ".join(
        f"S={S} {r['rate']:.1f} Msamples/s" for S, r in sweep.items()))
    del frames
    punctured = {}
    for code_rate in PUNCTURED:
        frames = fleet_frames(dev, gen, code_rate)
        _, p_run, _ = main_path(dev, gen, frames, code_rate)
        punctured[code_rate] = dict(launches=p_run["launches"],
                                    stages_ms=p_run["stages"],
                                    chain_msamples_per_s=p_run["rate"])
        seg[code_rate] = segmented_path(dev, frames, code_rate, 8)
        seg[code_rate].pop("captured")
        del frames
    btimes = banked_times(dev, gen)
    b0 = btimes[0]                      # 3/4 ACQUIRE: the headline shape
    rng = np.random.default_rng(SEED)
    stimuli = {}
    single = [single_carrier(dev, rng, stimuli, *p) for p in SC_PATHS]
    del stimuli
    ftimes = fir_times(dev, gen)
    fft = fft_times(dev, gen)
    # Each path's own count (zeroed just before it, read just after).
    by_path = {"fleet 1/2": launches}
    by_path.update({f"fleet {r}": p["launches"] for r, p in punctured.items()})
    by_path.update({f"fleet {r} S=8": p["launches"] for r, p in seg.items()})
    by_path.update({r["path"]: r["launches"] for r in single})
    resample = next(r for r in single if r["path"] == "resample")

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
         "segmented_shapes": seg_times,
         "segmented_plain": [dict(lanes=c, nsamp=SC_DEMOD_CHECK, plain_ms=ms)
                             for c, ms in seg_checks],
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
         "launches": punctured["3/4"]["launches"]["acs_banked"],
         "max_abs_err": b_err, "ms": b0["ms"], "plain_ms": b_plain,
         "bound_ms": b0["bound_ms"], "bound_by": b0["bound_by"],
         "library_ms": None,
         "shape": f"rate {b0['rate']} N={b0['N']} T={b0['T']}",
         "shapes": btimes,
         "plain_shape": f"rate 3/4 N={b_plain_n} T=1024"},
        {"name": "cfir", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fir.cu",
         "replaces": "leansdr_tpu/dsp/fir_pallas.py:62",
         "launches": resample["launches"]["cfir"], "max_abs_err": f_err,
         "ms": ftimes["cfir"]["ms"], "plain_ms": f_plain_c,
         "bound_ms": ftimes["cfir"]["bound"][0],
         "bound_by": ftimes["cfir"]["bound"][1],
         "library_ms": ftimes["cfir"]["library_ms"],
         "shape": ftimes["cfir"]["shape"],
         "plain_shape": "n=131157 nt=79"},
        {"name": "fir", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fir.cu",
         "replaces": "leansdr_tpu/dsp/fir_pallas.py:25",
         "launches": resample["launches"]["fir"], "max_abs_err": f_err,
         "ms": ftimes["fir"]["ms"], "plain_ms": f_plain_r,
         "bound_ms": ftimes["fir"]["bound"][0],
         "bound_by": ftimes["fir"]["bound"][1],
         "library_ms": ftimes["fir"]["library_ms"],
         "shape": ftimes["fir"]["shape"],
         "plain_shape": "R=128 n=131157 nt=79"},
        {"name": "fft4096", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fft4096.cu",
         "replaces": "leansdr_tpu/dsp/fft_pallas.py:58",
         "launches": launches["fft4096"], "max_abs_err": fft_err,
         "ms": fft["ms"], "plain_ms": fft["plain_ms"],
         "bound_ms": fft["bound_ms"], "bound_by": fft["bound_by"],
         "library_ms": fft["library_ms"], "shape": fft["shape"],
         "rel_err_plain": fft_rel_plain, "rel_err_library": fft_rel_lib,
         "plain_shape": fft["shape"]},
    ]
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
    print(json.dumps({"stages_ms": stages, "chain_msamples_per_s": rate,
                      "pipelined_msamples_per_s": piped_rate,
                      "punctured": punctured, "segmented": seg,
                      "segment_sweep": sweep, "single_carrier": single,
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
