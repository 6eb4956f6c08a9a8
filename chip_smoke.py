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
  1. card name and power limit, versions, kernel build time; dependent
     instruction latencies on the card (tools/latency_probe.cu) and the
     serial chains of the demod (per sample), of the ACS kernel (per
     trellis block, ACQUIRE and TRACK) and of the banked ACS kernel (per
     block at each B, through its shared-memory exchange and barrier)
     counted from their SASS (tools/sass_chain.py on `cuobjdump -sass` of
     the built libraries), each also as one warp issuing it in order;
  2. the demod's rotation (sincosf) == torch.cos / torch.sin bit for bit
     on all 65536 u16 angles; demod kernel == demod_ref, every packed
     word and every state plane bit for bit (DEMOD_CHECKS: QPSK at C=64
     and C=8192, 8PSK at C=64, 4096 samples; QPSK and 16APSK at C in
     {1, 33, 100} over 1024 samples and C=33 over 128, the ragged
     32-channel blocks and the copy ring's prologue and epilogue; the
     plain version costs one launch per op per sample);
  3. ACS kernel == viterbi_acs_ref bit for bit (ties forced, from zero
     and from a live state; T=2048 at the fleet's N=256 ACQUIRE lanes
     with and without cheap_q and its N=64 TRACK lanes with cheap_q;
     T=128 at the single carrier's N=4 replica lanes without cheap_q;
     the callers' int16 cost extremes at the fleet's shapes; one full
     TRACK decode, N=64 x T=2^17 with ties, against its plain version
     run on the host CPU in a child process while the fleet runs);
     banked ACS kernel == viterbi_acs_banked_ref bit for bit at 4/6,
     3/4, 5/6 and 7/8 (ties forced, from zero and from a live state;
     T=1024 at each rate's fleet ACQUIRE lanes, at TRACK's 64 and at
     N=200; T=128 at the single carrier's nsyncs lanes, 8 to 16; the
     int16-sum cost extremes at the ACQUIRE and TRACK lanes; one full
     TRACK decode at 3/4 and at 7/8, N=64 at the fleet's T, against its
     plain version on the host CPU in a child process);
     cfir == cfir_ref and fir == fir_ref bit for bit (nt 21, 79, 2048;
     lengths off the tile; fir also at its tile's edges, FIR_EDGE_*;
     from a zero head and mid-stream; cfir also
     decimated: the --resample stage's launch at its shape, ragged
     counts, other steps); fft4096
     within max|dy| / max|y| < 2e-5 of fft4096_ref and of torch.fft.fft
     at B=8, 1024 and 1064 (the sums run in other orders); torch.argmax takes
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
     segmented launches' shapes and at one carrier; the ACS at N=256,
     N=64 and N=4; the banked ACS at every rate's ACQUIRE and TRACK
     lanes and the hq 3/4 launch, with cycles per block beside its SASS
     chain and in-order issue), bounds (the demod's and the ACS's serial
     bounds from phase 1), one `kernels` line (cfir full rate and
     decimated, and fir, beside one conv1d computing the same FIR, TF32
     off, each with its conv1d as device time from CUDA-graph replays in
     turns and as host-paced calls; fft4096 beside one torch.fft.fft, in turns over
     inputs that exceed the L2, timed in phase 3 right after its check);
  6. last line: {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present.
"""

import atexit
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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
FFT_BUFFERS = 6                  # fft timing inputs in turn: 192 MB > L2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
VECTOR_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# Integer work (the ACS kernels) is priced at the INT32 issue rate: a
# Hopper SM has 64 INT32 lanes, so 64 integer operations per SM per
# clock, times the SMs (132 on the H100 SXM) and the max SM clock that
# nvidia-smi reports (1980 MHz there): ~16.7e12/s. The 67e12 above is the
# FP32 FMA rate counting each FMA as two operations, 4x the INT32 rate.
INT32_OPS_PER_SM_CLOCK = 64
PUNCTURED = ("3/4", "7/8")       # main-path rates of the banked ACS
# Demod kernel against demod_ref, every word and state plane bit for
# bit: (constellation, rate, nsym, C, nsamp). The fleet's widths, then
# the ragged edges of the 32-channel blocks and of the copy ring (C=33
# at 128 samples: one chunk, the ring's prologue and epilogue alone).
DEMOD_CHECKS = (
    ("QPSK", "1/2", 4, NCHAN, 4096), ("QPSK", "1/2", 4, 8192, 4096),
    ("PSK8", "2/3", 8, NCHAN, 4096),
) + tuple((p, r, m, C, n) for p, r, m in (("QPSK", "1/2", 4),
                                          ("APSK16", "3/4", 16))
          for C, n in ((1, 1024), (33, 1024), (100, 1024), (33, 128)))
# The demod's serial bound is counted from the built kernel's SASS
# (tools/sass_chain.py on `cuobjdump -sass`: the instructions on the
# QPSK loop's loop-carried path, each at its latency as
# tools/latency_probe.cu measures it on this card). It supersedes an
# assumed count, 90 dependent operations per sample at 4 cycles, still
# printed beside it.
ASSUMED_CHAIN_CYCLES = 90 * 4
DEMOD_QPSK_FUNCTION = "demod_kernelILb1E"     # demod_kernel<true>
TOOLS = Path(__file__).resolve().parent / "tools"
LATENCY_PROBES = 24                           # tools/latency_probe.cu
# The ACS kernel's per-block chain, from its SASS the same way: per
# mode (function, marker, markers per block, least markers in the
# loop). This kernel's loops hold its warp reductions (REDUX, no MUFU):
# two per block in ACQUIRE (best and second-best key), 1.25 in TRACK
# (cheap_q: the second-best on one block in four). The parent kernel
# (before the lagged normalisation; tools/kernel_ab.py counts it)
# reduced by shuffles and the compiler versioned its one loop on
# cheap_q: TRACK's, 65 SHFL per 4 blocks (2 inputs, 8 metric and path,
# 5 reduction levels each, and 5 more for the one q), is the smaller;
# ACQUIRE's holds 80 (20 per block).
ACS_FUNCTIONS = {"acquire": ("acs_kernelILb0E", "REDUX", 2.0, 1),
                 "track": ("acs_kernelILb1E", "REDUX", 1.25, 1)}
ACS_LEGACY_FUNCTIONS = {"acquire": ("acs_kernel", "SHFL", 20.0, 80),
                        "track": ("acs_kernel", "SHFL", 16.25, 1)}
# The single-carrier paths' launches held against the plain versions:
# the first launch of each kernel and this one (a live, mid-stream
# state); the demod on this many samples of its read.
SC_LIVE_LAUNCH = {"demod": 20, "cfir": 20, "acs": 4000, "acs_banked": 4000}
SC_DEMOD_CHECK = 1024
ACS_LONG_T = 1 << 17             # blocks of one TRACK decode (main path)
# cfir's decimated launches held against cfir_ref, per filter length:
# (start, step, count). At 79 taps the --resample stage's launch on one
# of its reads (FirFilterDevice: start nt, step decim 7, every output it
# keeps), then ragged counts (off the 128-output tile) and other steps.
RESAMPLE_NT, RESAMPLE_N, RESAMPLE_DECIM = 79, (1 << 17) + 85, 7
CFIR_DECIMATED = {
    21: ((21, 3, 5000), (0, 5, 10000), (7, 1, 129)),
    79: ((79, 7, (RESAMPLE_N - 79) // 7), (79, 7, 1000), (2, 2, 65535)),
    2048: ((2048, 7, 993), (0, 11, 817)),
}
# fir against fir_ref at its tile's edges (FIR_TILE = 512 outputs, taps
# in groups of 4): tap counts and row lengths.
FIR_EDGE_TAPS = (1, 3, 4, 65)
FIR_EDGE_LENGTHS = (1, 5, 511, 512, 513, 1024, 1025)
CHILDREN = []                    # processes this script started


def _stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(_stop_children)


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


def start_probe_build():
    """nvcc on tools/latency_probe.cu, started beside the kernels' build;
    latency_table waits for it. Returns (process, library path)."""
    from leansdr_tpu_torch import device as kdev
    kdev.BUILD.mkdir(exist_ok=True)
    so = kdev.BUILD / "liblatency_probe.so"
    cmd = ([kdev.nvcc_path()] + kdev.ARCH
           + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              str(TOOLS / "latency_probe.cu"), "-o", str(so)])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def latency_table(build, dev) -> tuple:
    """Dependent-instruction latencies in cycles on this card, from
    tools/latency_probe.cu, keyed for tools/sass_chain.py: `fixed` (every
    fixed-latency pipe) is the largest of FADD, FMUL, FFMA, FMNMX, FSEL,
    SHF and IMAD; FSETP, MUFU.RCP, MUFU.SIN and MUFU.RSQ are their pair
    less the partner; F2I and I2F(P) half their pair. Returns (the
    demod's table, the keys its chain count uses; the integer table for
    the ACS kernels: that plus SHFL.IDX, SHFL.BFLY, IMNMX/VIMNMX/VIMNMX3,
    SEL, ISETP (its pair less SEL), REDUX, VIADDMNMX, and the shared-memory
    exchange: STS priced 0 and BAR (or WARPSYNC) as the measured round
    STS + BAR.SYNC + LDS (STS + __syncwarp + LDS) less the LDS, the
    rounds themselves beside them)."""
    proc, so = build
    text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"latency probe build failed:\n{text}")
    lib = ctypes.CDLL(str(so))
    lib.run_probes.restype = ctypes.c_int
    lib.run_probes.argtypes = [ctypes.c_void_p] * 4
    lib.probe_rep.restype = ctypes.c_int
    lib.probe_rep.argtypes = []
    fin = torch.tensor([1.5, 1.0, 0.999], device=dev)
    iin = torch.ones(2, dtype=torch.int32, device=dev)
    fout = torch.zeros(LATENCY_PROBES + 1, device=dev)
    cyc = torch.zeros(LATENCY_PROBES, dtype=torch.int64, device=dev)
    for _ in range(2):                    # the second run is warm
        err = lib.run_probes(fin.data_ptr(), iin.data_ptr(),
                             fout.data_ptr(), cyc.data_ptr())
        if err != 0:
            fail(f"latency probe: CUDA error {err}")
    (fadd, fmul, ffma, fmnmx, fsel, fsetp_fsel, shf, imad, conv_pair, trunc,
     floor, rcp_fadd, sin_pair, rsq_fadd, lds, shfl_idx, shfl_bfly, imnmx,
     sel, isetp_sel, redux, xchg_bar, xchg_warp, viaddmnmx) = (
        cyc.cpu().double() / lib.probe_rep()).tolist()
    lat = {"fixed": max(fadd, fmul, ffma, fmnmx, fsel, shf, imad),
           "FSETP": fsetp_fsel - fsel, "F2I": conv_pair / 2,
           "I2F": conv_pair / 2, "I2FP": conv_pair / 2, "FRND.TRUNC": trunc,
           "FRND.FLOOR": floor, "FRND": max(trunc, floor),
           "MUFU.RCP": rcp_fadd - fadd, "MUFU.SIN": sin_pair - fmul,
           "MUFU.COS": sin_pair - fmul, "MUFU.RSQ": rsq_fadd - fadd,
           "LDS": lds}
    lat_int = dict(lat, **{"SHFL.IDX": shfl_idx, "SHFL.BFLY": shfl_bfly,
                           "IMNMX": imnmx, "VIMNMX": imnmx,
                           "VIMNMX3": imnmx, "SEL": sel,
                           "ISETP": isetp_sel - sel, "REDUX": redux,
                           "VIADDMNMX": viaddmnmx, "STS": 0.0,
                           "BAR": xchg_bar - lds,
                           "WARPSYNC": xchg_warp - lds,
                           "round STS+BAR.SYNC+LDS": xchg_bar,
                           "round STS+__syncwarp+LDS": xchg_warp})
    print("dependent latency, cycles (tools/latency_probe.cu): "
          + ", ".join(f"{k} {v:.2f}" for k, v in lat_int.items()))
    return lat, lat_int


def sass_of(so) -> str:
    """`cuobjdump -sass` of a built library."""
    from leansdr_tpu_torch import device as kdev
    cuobjdump = Path(kdev.nvcc_path()).parent / "cuobjdump"
    r = subprocess.run([str(cuobjdump), "-sass", str(so)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -sass {so}: {r.stderr}")
    return r.stdout


def acs_chain(so, lat_int, clock, functions=None) -> dict:
    """The rate-1/2 ACS kernel's loop-carried chain per trellis block
    from its built library's SASS (tools/sass_chain.py), per mode:
    {mode: analyse(...) result}. `functions` maps a mode to (function,
    marker, markers per block, least markers in the loop);
    ACS_FUNCTIONS by default."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    text = sass_of(so)
    out = {}
    for mode, (fn, marker, per, least) in (functions
                                           or ACS_FUNCTIONS).items():
        res = sass_chain.analyse(text, fn, lat_int, marker, None, per, least)
        out[mode] = res
        print(f"acs chain [{mode}] (tools/sass_chain.py on cuobjdump -sass "
              f"{Path(so).name}, {res['function']} loop {res['loop'][0]}-"
              f"{res['loop'][1]}, {res['unroll']:g} blocks per pass): "
              f"{res['cycles_per_step']:.1f} cycles per block "
              f"({res['cycles_per_step'] / clock * 1e9:.1f} ns at "
              f"{clock / 1e6:.0f} MHz), {res['path_instructions_per_step']:.1f}"
              f" instructions on the loop-carried path, "
              f"{res['instructions_per_step']:.1f} instructions per block, "
              f"{res['issue_cycles_per_step']:.1f} cycles per block issued "
              f"in order by one warp; "
              f"mix {res['mix']}; priced as fixed-pipe: "
              f"{', '.join(res['priced_as_fixed'])}")
    return out


def demod_chain(so, lat, clock) -> dict:
    """The demod's serial bound per sample from its built library's SASS
    (tools/sass_chain.py on the QPSK loop of `cuobjdump -sass`)."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    res = sass_chain.analyse(sass_of(so), DEMOD_QPSK_FUNCTION, lat)
    print(f"demod serial chain (tools/sass_chain.py on cuobjdump -sass "
          f"{so.name}, QPSK loop {res['loop'][0]}-{res['loop'][1]}): "
          f"{res['path_instructions_per_step']:.0f} instructions on the "
          f"loop-carried path, {res['cycles_per_step']:.1f} cycles per "
          f"sample ({res['cycles_per_step'] / clock * 1e9:.1f} ns at "
          f"{clock / 1e6:.0f} MHz; assumed before: {ASSUMED_CHAIN_CYCLES}); "
          f"{res['instructions_per_step']:.0f} hot-path instructions per "
          f"sample, {res['issue_cycles_per_step']:.1f} cycles per sample "
          f"issued in order by one warp; priced as fixed-pipe: "
          f"{', '.join(res['priced_as_fixed'])}")
    return res


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


def check_sincos(dev):
    """The demod's rotation (sincosf, through demod_sincos_launch) against
    torch.cos and torch.sin, bit for bit, on every angle its loop can
    see: idx * K2PI for the 65536 u16 angles idx (wrap_angle's range)."""
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    lib = rk._kernel()
    lib.demod_sincos_launch.restype = ctypes.c_int
    lib.demod_sincos_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    a = torch.arange(65536, dtype=torch.float32, device=dev) * rk.K2PI
    c, s = torch.empty_like(a), torch.empty_like(a)
    err = lib.demod_sincos_launch(a.data_ptr(), c.data_ptr(), s.data_ptr(),
                                  a.numel(), torch.cuda.current_stream(
                                      dev).cuda_stream)
    if err != 0:
        fail(f"demod_sincos_launch: CUDA error {err}")
    bad = int((c != torch.cos(a)).sum()) + int((s != torch.sin(a)).sum())
    print(f"demod rotation (sincosf) == torch.cos / torch.sin on all "
          f"{a.numel()} u16 angles: {bad} differing values")
    if bad:
        fail(f"the demod's sincosf differs from torch.cos/torch.sin at "
             f"{bad} values")


def check_demod(name, rate, nsym, C, nsamp, dev, gen):
    """The demod kernel against demod_ref on demod_stimulus from the
    cold-start state: every packed word and every state plane equal.
    Returns (state max |diff|, plain ms)."""
    from leansdr_tpu_torch.dsp import receiver, receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    predef = Predef[name]
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
    words = int((pk_k != pk_r).sum())
    planes_equal = torch.equal(st_k, st_r)
    nvalid = int(((pk_r >> 24) & 1).sum())
    err = float((st_k - st_r).abs().max())
    print(f"demod {name:6s} C={C:5d} nsamp={nsamp}: valid symbols "
          f"{nvalid}, differing words {words}, state planes bit-equal "
          f"{planes_equal} (max |d| {err:.3g}), plain {plain_ms:.0f} ms")
    if words or not planes_equal or nvalid < C * nsamp // 4:
        fail(f"demod kernel != demod_ref ({name}, C={C}, "
             f"nsamp={nsamp})")
    return err, plain_ms


# ---------------------------------------------------------------- phase 3

def check_acs(dev, gen):
    """acs == viterbi_acs_ref bit for bit: T=2048 at the fleet's N=256
    ACQUIRE lanes with and without cheap_q and its N=64 TRACK lanes with
    cheap_q, T=128 at the single carrier's N=4 lanes; costs 0..-3 (ties
    forced) and, at the fleet's shapes, the callers' int16 extremes
    (-2^15, 2^15 - 1, 0 or anything between: the lagged normalisation's
    headroom); round 0 from zero planes, round 1 from the kernel's end
    state. Returns (max |diff|, plain ms at N=256, T=2048, ties)."""
    from leansdr_tpu_torch.fec import viterbi_device as vd
    out = []
    for N, cheap_q, T, costs in ((NCHAN * vd.NSYNCS, False, 2048, "ties"),
                                 (NCHAN * vd.NSYNCS, True, 2048, "ties"),
                                 (NCHAN, True, 2048, "ties"),
                                 (sc_lanes("1/2", dev), False, 128, "ties"),
                                 (NCHAN * vd.NSYNCS, False, 2048, "int16"),
                                 (NCHAN, True, 2048, "int16")):
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)
        m0, p0 = z, z
        for rnd in range(2):      # second round starts from a live state
            cs = torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                               generator=gen)
            cost = acs_costs(costs, T, N, dev, gen)
            k = vd.viterbi_acs("1/2", m0, p0, cs, cost, cheap_q=cheap_q)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = vd.viterbi_acs_ref("1/2", m0, p0, cs, cost, cheap_q=cheap_q)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for name, a, b in zip(("metric", "path", "us", "q"), k, r):
                if not torch.equal(a, b):
                    fail(f"ACS N={N} cheap_q={cheap_q} costs {costs} round "
                         f"{rnd}: {name} differs in "
                         f"{int((a != b).sum())} entries")
            err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs()
                            .max()) for a, b in zip(k, r))
            print(f"acs cheap_q={cheap_q!s:5s} N={N} T={T} costs {costs} "
                  f"round {rnd}: bit-equal, plain {plain_ms:.0f} ms")
            out.append((err, plain_ms))
            m0, p0 = k[0], k[1]
    return max(e for e, _ in out), out[0][1]


def acs_costs(kind, T, N, dev, gen):
    """ACS block costs [T, N] int32: "ties", 0..-3 (metric ties on most
    blocks); "int16", the callers' extremes -2^15, 2^15 - 1 and 0, or
    anything between, a quarter each."""
    if kind == "ties":
        return -torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                              generator=gen)
    pick = torch.randint(0, 4, (T, N), device=dev, generator=gen)
    any16 = torch.randint(-(1 << 15), 1 << 15, (T, N), device=dev,
                          dtype=torch.int32, generator=gen)
    ext = torch.tensor([-(1 << 15), (1 << 15) - 1, 0], dtype=torch.int32,
                       device=dev)
    return torch.where(pick < 3, ext[pick.clamp(max=2)], any16)


def start_plain(what, fn, args, kwargs, k, names):
    """Run leansdr_tpu_torch.<fn>(*args, **kwargs), a kernel's plain
    version, on this host's CPU in a child process (`--plain`) while the
    later phases run: on the card it costs ~0.5 ms of small ops per
    block, and integer arithmetic gives the same bits on either device.
    `k` are the kernel's outputs on the same inputs, `names` theirs.
    Returns what finish_plain needs."""
    from leansdr_tpu_torch import device as kdev
    src = kdev.BUILD / f"plain_{len(CHILDREN)}_in.pt"
    dst = kdev.BUILD / f"plain_{len(CHILDREN)}_out.pt"
    dst.unlink(missing_ok=True)
    torch.save(dict(fn=fn, args=[a.cpu() if torch.is_tensor(a) else a
                                 for a in args], kwargs=kwargs), src)
    proc = subprocess.Popen([sys.executable, __file__, "--plain", str(src),
                             str(dst)])
    CHILDREN.append(proc)
    return what, names, proc, dst, [v.cpu() for v in k], time.perf_counter()


def finish_plain(job):
    """Wait for a start_plain child; every output equal bit for bit."""
    what, names, proc, dst, k, t0 = job
    if proc.wait(timeout=900) != 0:
        fail(f"{what}: plain child exited {proc.returncode}")
    r = torch.load(dst)
    for name, a, b in zip(names, k, r):
        if not torch.equal(a, b):
            fail(f"{what}: {name} differs from the plain version in "
                 f"{int((a != b).sum())} entries")
    print(f"{what}: bit-equal to the plain version on the host CPU "
          f"({time.perf_counter() - t0:.0f} s since launch)")


def plain_job(src, dst):
    """The child of start_plain, on one thread at the lowest priority (the
    parent's host stages are being timed meanwhile)."""
    import importlib
    os.nice(19)
    torch.set_num_threads(1)
    a = torch.load(src)
    mod, name = a["fn"].rsplit(".", 1)
    fn = getattr(importlib.import_module(f"leansdr_tpu_torch.{mod}"), name)
    torch.save(fn(*a["args"], **a["kwargs"]), dst)


def start_long_acs(dev, gen):
    """acs over one full TRACK decode of the main path (N=64 lanes,
    T=2^17 blocks, cheap_q, ties) from a live state, against its plain
    version in a start_plain child."""
    from leansdr_tpu_torch.fec import viterbi_device as vd
    N, T = NCHAN, ACS_LONG_T
    z = torch.zeros((64, N), dtype=torch.int32, device=dev)
    cs0 = torch.randint(0, 4, (64, N), device=dev, dtype=torch.int32,
                        generator=gen)
    m0, p0, _, _ = vd.viterbi_acs("1/2", z, z, cs0,
                                  acs_costs("ties", 64, N, dev, gen),
                                  cheap_q=True)
    cs = torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                       generator=gen)
    cost = acs_costs("ties", T, N, dev, gen)
    k = vd.viterbi_acs("1/2", m0, p0, cs, cost, cheap_q=True)
    return start_plain(f"acs cheap_q=True  N={N} T={T} costs ties (one "
                       f"TRACK decode, live state)",
                       "fec.viterbi_device.viterbi_acs_ref",
                       ("1/2", m0, p0, cs, cost), dict(cheap_q=True), k,
                       ("metric", "path", "us", "q"))


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


def banked_costs(kind, rate, T, N, dev, gen):
    """Banked ACS block costs [T, N] int32: "ties", 0, -3, -6 or -9
    (metric ties on most blocks); "int16", the sum of the rate's nshifts
    symbols' costs (bits_out / 2 QPSK symbols per block), each at the
    callers' extremes -2^15, 2^15 - 1, 0 or anything between (acs_costs):
    the headroom of the kernel's normalisation."""
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    if kind == "ties":
        return -3 * torch.randint(0, 4, (T, N), device=dev,
                                  dtype=torch.int32, generator=gen)
    return sum(acs_costs("int16", T, N, dev, gen)
               for _ in range(make_trellis(rate).bits_out // 2))


def check_acs_banked(dev, gen):
    """acs_banked == viterbi_acs_banked_ref bit for bit at every fleet
    punctured rate: T=1024 at the fleet main path's lane counts (the
    rate's ACQUIRE lanes, 64 carriers x nsyncs, and TRACK's 64) and at
    N=200 (not a multiple of 32), coarse costs forcing metric ties; T=128
    (one single-carrier chunk) at the single carrier's nsyncs lanes; and
    the int16-sum cost extremes at the fleet's ACQUIRE and TRACK lanes;
    round 0 from zero planes, round 1 from the kernel's end state.
    Returns (max |diff|, plain ms at 3/4 ACQUIRE round 0, its N)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    err, plain = 0.0, None
    for rate in vb.FLEET_RATES:
        ncs = make_trellis(rate).ncs
        n_acq = fleet_plan(rate, dev).n_lanes
        for N, T, costs in ((n_acq, 1024, "ties"), (NCHAN, 1024, "ties"),
                            (200, 1024, "ties"),
                            (sc_lanes(rate, dev), 128, "ties"),
                            (n_acq, 1024, "int16"), (NCHAN, 1024, "int16")):
            z = torch.zeros((64, N), dtype=torch.int32, device=dev)
            planes = (z, z, z)
            for rnd in range(2):
                cs = torch.randint(0, ncs, (T, N), device=dev,
                                   dtype=torch.int32, generator=gen)
                cost = banked_costs(costs, rate, T, N, dev, gen)
                k = vb.viterbi_acs_banked(rate, *planes, cs, cost)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = vb.viterbi_acs_banked_ref(rate, *planes, cs, cost)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                for name, a, b in zip(("metric", "hi", "lo", "us", "q"), k,
                                      r):
                    if not torch.equal(a, b):
                        fail(f"acs_banked {rate} N={N} costs {costs} round "
                             f"{rnd}: {name} differs in "
                             f"{int((a != b).sum())} entries")
                err = max(err, max(float((a.to(torch.int64)
                                          - b.to(torch.int64)).abs().max())
                                   for a, b in zip(k, r)))
                print(f"acs_banked {rate} N={N} T={T} costs {costs} round "
                      f"{rnd}: bit-equal, plain {plain_ms:.0f} ms")
                if rate == "3/4" and N == n_acq and rnd == 0 and plain is None:
                    plain = (plain_ms, N)
                planes = k[:3]
    return err, plain[0], plain[1]


def start_long_banked(dev, gen, rate):
    """acs_banked over one full TRACK decode of the fleet's main path at
    `rate` (N=64 lanes, the plan's T blocks, ties) from a live state,
    against its plain version in a start_plain child."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    N, T = NCHAN, fleet_plan(rate, dev).nblocks
    ncs = vb.bank_geometry(rate).ncs
    z = torch.zeros((64, N), dtype=torch.int32, device=dev)
    cs0 = torch.randint(0, ncs, (64, N), device=dev, dtype=torch.int32,
                        generator=gen)
    planes = vb.viterbi_acs_banked(rate, z, z, z, cs0,
                                   banked_costs("ties", rate, 64, N, dev,
                                                gen))[:3]
    cs = torch.randint(0, ncs, (T, N), device=dev, dtype=torch.int32,
                       generator=gen)
    cost = banked_costs("ties", rate, T, N, dev, gen)
    k = vb.viterbi_acs_banked(rate, *planes, cs, cost)
    return start_plain(f"acs_banked {rate} N={N} T={T} costs ties (one "
                       f"TRACK decode, live state)",
                       "fec.viterbi_banked.viterbi_acs_banked_ref",
                       (rate, *planes, cs, cost), {}, k,
                       ("metric", "hi", "lo", "us", "q"))


def check_fir(dev, gen):
    """cfir == cfir_ref and fir == fir_ref bit for bit (both built with
    --fmad=false) at nt in {21, 79, 2048}, at lengths that are not
    multiples of the kernels' tiles, from a stream head (zeros before it)
    and from mid-stream; fir on 128 rows; cfir also decimated
    (CFIR_DECIMATED: the --resample stage's launch, start nt, step 7,
    every output it keeps, at its shape; ragged counts and other steps
    at the other filter lengths). Returns (max |diff|, plain cfir ms and
    plain fir ms at nt=79, n=2^17+85, the --resample path's shape)."""
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    err, plain = 0.0, {}
    for nt, n in ((21, 50001), (79, (1 << 17) + 85), (2048, 9000)):
        for head in (True, False):
            x = 40 * torch.randn((2, n), device=dev, generator=gen)
            if head:
                x[:, :nt] = 0
            w = torch.randn((2, nt), device=dev, generator=gen) / nt ** 0.5
            tr, ti = w[0].contiguous(), w[1].contiguous()
            for start, step, count in ((0, 1, None),) + CFIR_DECIMATED[nt]:
                k = fk.cfir(x, tr, ti, start, step, count)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fk.cfir_ref(x, tr, ti, start, step, count)
                torch.cuda.synchronize()
                if step == 1:
                    plain["cfir", nt] = (time.perf_counter() - t0) * 1e3
                if not torch.equal(k, r):
                    fail(f"cfir nt={nt} n={n} head={head} start={start} "
                         f"step={step} count={count}: "
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
        print(f"cfir/fir nt={nt} n={n}: bit-equal (head and mid-stream; "
              f"cfir also at (start, step, count) "
              f"{[c for c in CFIR_DECIMATED[nt]]}), plain "
              f"{plain['cfir', nt]:.0f} / {plain['fir', nt]:.0f} ms")
    # fir's tile edges: one and a few outputs, one short of, at and one
    # past its 512-output tile and two, tap counts off and on its 4-tap
    # groups.
    for nt in FIR_EDGE_TAPS:
        tr = torch.randn(nt, device=dev, generator=gen) / nt ** 0.5
        for n in FIR_EDGE_LENGTHS:
            xr = 40 * torch.randn((3, n), device=dev, generator=gen)
            k, r = fk.fir(xr, tr), fk.fir_ref(xr, tr)
            if not torch.equal(k, r):
                fail(f"fir nt={nt} n={n}: {int((k != r).sum())} outputs "
                     f"differ")
            err = max(err, float((k - r).abs().max()))
    print(f"fir tile edges: bit-equal at nt {FIR_EDGE_TAPS} x n "
          f"{FIR_EDGE_LENGTHS} (3 rows)")
    return err, plain["cfir", 79], plain["fir", 79]


def check_fft(dev, gen):
    """fft4096 against fft4096_ref (TF32 off) and torch.fft.fft at B=8,
    1024 and 1064 (8 x 133, not a power of two), unit-variance planes:
    max|dy| / max|y| < FFT_BAR (the sums run in other orders, so not bit
    for bit). Returns (max |dy| against the plain version, the largest
    relative error against each)."""
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    err, rel_plain, rel_lib = 0.0, 0.0, 0.0
    for B in (8, 1024, 1064):
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


def chain_ms(nsamp: int, chain: dict, clock: float) -> dict:
    """The demod's serial bound for nsamp samples: the SASS count's and,
    superseded, the assumed count's (ms)."""
    return dict(chain_bound_ms=nsamp * chain["cycles_per_step"] / clock
                * 1e3,
                chain_bound_ms_assumed=nsamp * ASSUMED_CHAIN_CYCLES / clock
                * 1e3)


def kernel_times(rx, frames, dev, gen, chain, acs_chain_res):
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
    out = {"demod": dict(ms=demod_ms, bound=bound_ms(d_bytes, d_ops),
                         shape=f"C={C} nsamp={n}", **chain_ms(n, chain,
                                                              clock))}
    # A fleet wide enough to occupy every SM (8192 channels = 256 warps),
    # and one carrier over one of leandvb's 2^17-sample reads.
    for key, Cw, nw in (("demod_wide", 8192, 1 << 15),
                        ("demod_one", 1, 1 << 17)):
        rows = torch.arange(Cw, device=dev) % C
        xw = xm[rows, :nw + 1].contiguous()
        pw = planes[:, rows].contiguous()
        ms = cuda_time(lambda: rk.demod(rx.params, rx._sym_consts, pw, xw),
                       reps=3)
        out[key] = dict(
            ms=ms, bound=bound_ms((nw + 1) * Cw * 8 + nw * Cw * 4,
                                  110.0 * nw * Cw),
            shape=f"C={Cw} nsamp={nw}", **chain_ms(nw, chain, clock))
        del xw, pw
    T = rx.deconv.plan.nblocks
    # ACQUIRE (N=256) and TRACK (N=64, cheap_q) of the fleet, one decode
    # of T=2^17 blocks; the hq 1/2 single carrier's N=4 replica lanes over
    # one 128-block chunk (device time from graph replays of 50 calls:
    # the host paces back-to-back calls of a kernel this short).
    for N, cheap_q, Tk, key in ((C * vd.NSYNCS, False, T, "acs"),
                                (C, True, T, "acs_track"),
                                (sc_lanes("1/2", dev), False, 128, "acs_sc")):
        cs = torch.randint(0, 4, (Tk, N), device=dev, dtype=torch.int32,
                           generator=gen)
        cost = -torch.randint(0, 40, (Tk, N), device=dev, dtype=torch.int32,
                              generator=gen)
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)

        def call():
            return vd.viterbi_acs("1/2", z, z, cs, cost, cheap_q=cheap_q)
        ms = (float(np.median(graph_ms({"acs": call})["acs"])) if Tk == 128
              else cuda_time(call, reps=3))
        a_bytes = Tk * N * 16 + 4 * 64 * N * 4
        a_ops = Tk * N * 64 * 16.0       # ~16 integer ops per state
        ops_b = bound_ms(a_bytes, a_ops, int32_ops_per_s(clock))
        mode = "track" if cheap_q else "acquire"
        cyc = acs_chain_res[mode]["cycles_per_step"]
        chain_b = Tk * cyc / clock * 1e3
        out[key] = dict(ms=ms, bound=ops_b, chain_bound_ms=chain_b,
                        chain_cycles_per_block=cyc,
                        cycles_per_block=ms * 1e-3 * clock / Tk,
                        shape=f"N={N} T={Tk} cheap_q={cheap_q}")
    for k, v in out.items():
        note = (f", serial chain bound {v['chain_bound_ms']:.3f} ms (the "
                f"assumed count, superseded: "
                f"{v['chain_bound_ms_assumed']:.3f})"
                if "chain_bound_ms_assumed" in v else
                f", {v['cycles_per_block']:.1f} cycles per block; SASS chain"
                f" {v['chain_cycles_per_block']:.1f} cycles per block, "
                f"{v['chain_bound_ms']:.4f} ms (the bound: the larger of "
                f"the two)"
                if "chain_cycles_per_block" in v else "")
        print(f"kernel {k:10s} {v['shape']}: {v['ms']:.3f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}){note}")
    print(f"demod rate: {C * n / out['demod']['ms'] / 1e3:.1f} Msamples/s "
          f"at C={C}, {8192 * (1 << 15) / out['demod_wide']['ms'] / 1e3:.1f}"
          f" Msamples/s at C=8192; cycles per sample per carrier "
          + ", ".join(f"{out[k]['shape']} "
                      f"{out[k]['ms'] * 1e-3 * clock / m:.0f}"
                      for k, m in (("demod", n), ("demod_wide", 1 << 15),
                                   ("demod_one", 1 << 17)))
          + f" (max SM clock {clock / 1e6:.0f} MHz)")
    return out


def banked_ops(rate: str, T: int, N: int) -> float:
    """The least integer instructions the banked ACS function needs for
    T blocks over N lanes (what the function computes, each step counted
    at one instruction of the card, not the kernel's own mix), per block
    and lane:
      * 2 for the block: the rank ncs-1-cs of its coded symbol and its
        cost << RB;
      * 1 per predecessor state (64): its key base m << RB, shared by
        every row it feeds;
      * 1 per candidate (64 rows x K predecessors; at 7/8 a
        predecessor's two branches share its metric, so only the smaller
        of their static ranks can win, and the candidates are 64 x 64):
        one fused add-min (Hopper's VIADDMNMX) forms the key and folds it
        into the row's minimum;
      * 8 per row (9 at 7/8): the provided branch's key (add, min), the
        winner's path (hi: one funnel shift; lo: shift and or in one),
        its metric word (mask), its best-state key (shift and or in one),
        one step each of the best and second-best 64-way mins; at 7/8 the
        choice of the winning branch's uncoded symbol.
    (An earlier count, 3 per predecessor, 4 per slot (8 at 7/8) and 11
    per row (16 at 7/8), was more than the function needs.)"""
    from leansdr_tpu_torch.fec.viterbi_banked import bank_geometry
    geo = bank_geometry(rate)
    per_row = 9 if geo.B == 7 else 8
    return float(T) * N * (2 + 64 + 64 * geo.K + 64 * per_row)


def banked_chain(so, lat_int, clock) -> dict:
    """The banked ACS kernel's per-block chain and one warp's in-order
    issue, per B (3: 3/4, 4: 4/6, 5: 5/6, 7: 7/8), from its built
    library's SASS: tools/sass_chain.py on the block loop (one barrier
    per block; the ring reduction, once per 64 blocks behind a branch,
    left out), the shared-memory exchange counted (exchange=True)."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    text = sass_of(so)
    out = {}
    for B in (3, 4, 5, 7):
        res = sass_chain.analyse(text, f"acs_banked_kernelILi{B}E", lat_int,
                                 "BAR", None, 1.0, 1, exchange=True)
        out[B] = res
        print(f"acs_banked chain B={B} (tools/sass_chain.py on cuobjdump "
              f"-sass {Path(so).name}, {res['function'][:60]}... loop "
              f"{res['loop'][0]}-{res['loop'][1]}, {res['unroll']:g} blocks "
              f"per pass): {res['cycles_per_step']:.1f} cycles per block on "
              f"the chain (through the barrier), "
              f"{res['issue_cycles_per_step']:.1f} issued in order by one "
              f"warp, {res['instructions_per_step']:.1f} instructions per "
              f"block; mix {res['mix']}; priced as fixed-pipe: "
              f"{', '.join(res['priced_as_fixed'])}")
    return out


def banked_times(dev, gen, chain, clock):
    """acs_banked at the main path's shapes (64 carriers, chunk 2^18):
    ACQUIRE (64 x nsyncs lanes) and TRACK (64 lanes), at every fleet
    punctured rate (CUDA events, 2 calls), and the hq 3/4 single
    carrier's launch (its nsyncs lanes, T=128; device time from CUDA-graph
    replays of 50 calls), with bounds at the INT32 issue rate
    (banked_ops), cycles per block and, beside them, the SASS chain and
    one warp's in-order issue per block (banked_chain)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    out = []
    shapes = []
    for rate in ("3/4", "7/8", "5/6", "4/6"):
        plan = fleet_plan(rate, dev)
        shapes += [(rate, "acquire", plan.n_lanes, plan.nblocks),
                   (rate, "track", NCHAN, plan.nblocks)]
    shapes.append(("3/4", "hq", sc_lanes("3/4", dev), 128))
    for rate, mode, N, T in shapes:
        geo = vb.bank_geometry(rate)
        cs = torch.randint(0, geo.ncs, (T, N), device=dev,
                           dtype=torch.int32, generator=gen)
        cost = -torch.randint(0, 80, (T, N), device=dev,
                              dtype=torch.int32, generator=gen)
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)

        def call():
            return vb.viterbi_acs_banked(rate, z, z, z, cs, cost)
        ms = (float(np.median(graph_ms({"acs_banked": call})["acs_banked"]))
              if T == 128 else cuda_time(call, reps=2))
        b, by = bound_ms(T * N * 16 + 6 * 64 * N * 4,
                         banked_ops(rate, T, N), int32_ops_per_s(clock))
        c = chain[geo.B]
        cyc = ms * 1e-3 * clock / T
        out.append(dict(rate=rate, mode=mode, N=N, T=T, ms=ms, bound_ms=b,
                        bound_by=by, cycles_per_block=cyc,
                        chain_cycles_per_block=c["cycles_per_step"],
                        issue_cycles_per_block=c["issue_cycles_per_step"],
                        chain_bound_ms=T * c["cycles_per_step"] / clock
                        * 1e3))
        print(f"kernel acs_banked {rate} {mode:7s} N={N:4d} T={T}: "
              f"{ms:.4f} ms, bound {b:.4f} ms ({by}), {cyc:.1f} cycles per "
              f"block (SASS chain {c['cycles_per_step']:.1f}, one warp in "
              f"order {c['issue_cycles_per_step']:.1f}; chain bound "
              f"{out[-1]['chain_bound_ms']:.4f} ms), "
              f"{T / ms / 1e3:.2f} Mblocks/s per lane")
    return out


def graph_ms(fns: dict, reps: int = 50, rounds: int = 3) -> dict:
    """Device ms per call of each fn() without host pacing: `reps` calls
    of each captured in one torch.cuda.CUDAGraph (the ctypes launches on
    the capturing stream are captured with it), the replays timed with
    CUDA events in turns a, b, b, a (for two fns), `rounds` times.
    Returns {name: [ms per call, one per replay]}."""
    graphs = {}
    for name, fn in fns.items():
        fn()                                     # warm up (and build)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        graphs[name] = g
    torch.cuda.synchronize()
    names = list(fns)
    order = names + names[::-1]
    out = {k: [] for k in names}
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(rounds):
        for k in order:
            s.record()
            graphs[k].replay()
            e.record()
            torch.cuda.synchronize()
            out[k].append(s.elapsed_time(e) / reps)
    return out


def fir_times(dev, gen):
    """cfir at the --resample path's shape (one 2^17-sample read plus the
    filter history, 79 taps), full rate and decimated as the stage
    launches it (start nt, step 7), and fir at the bench baseline's shape
    (64 channels' re/im rows, 2^18 samples, 65 RRC taps,
    tools/bench_kernels.py:82-107), with bounds (bytes: input and output
    once; operations: 4 multiplies and 4 adds per complex tap, 1 and 1
    per real tap) and the library yardstick: one conv1d computing the
    same FIR (TF32 off), zero-padded for causality (stride 7 for the
    decimated outputs). Each cfir and fir, with its conv1d: device time
    per call from CUDA-graph replays in turns (graph_ms, the medians; the
    table's) and, as this script timed them before, CUDA events over
    back-to-back calls from the host (`host_paced`); fir also beside the
    FP32-issue floor of its exact order (one FMUL and one FADD per tap and
    output at 128 lanes per SM per clock)."""
    import torch.nn.functional as F
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    nt, n, dec = RESAMPLE_NT, RESAMPLE_N, RESAMPLE_DECIM
    x = 40 * torch.randn((2, n), device=dev, generator=gen)
    tr, ti = (torch.randn(nt, device=dev, generator=gen) for _ in range(2))
    # conv1d is a cross-correlation: flip the taps. Output channel 0 =
    # re (tr*xr - ti*xi), 1 = im (ti*xr + tr*xi).
    w = torch.stack([torch.stack([tr, -ti]), torch.stack([ti, tr])]).flip(-1)
    xp = F.pad(x, (nt - 1, 0))[None]
    count = (n - nt) // dec
    for key, args, lib in (
            ("cfir", (0, 1, None), lambda: F.conv1d(xp, w)),
            ("cfir_decimated", (nt, dec, count),
             lambda: F.conv1d(xp[..., nt:], w, stride=dec))):
        ref = fk.cfir(x, tr, ti, *args)
        lib_err = float((lib()[0, :, :ref.shape[1]] - ref).abs().max())
        g = graph_ms({"conv1d": lib, "cfir": lambda: fk.cfir(x, tr, ti,
                                                             *args)})
        ms, lib_ms = (float(np.median(g[k])) for k in ("cfir", "conv1d"))
        paced = cuda_time(lambda: fk.cfir(x, tr, ti, *args), reps=50)
        lib_paced = cuda_time(lib, reps=50)
        c = ref.shape[1]
        b = (bound_ms(2 * n * 4 + 2 * c * 4 + 2 * nt * 4, 8.0 * nt * c)
             if key == "cfir_decimated" else
             bound_ms(4 * n * 4 + 2 * nt * 4, 8.0 * nt * n))
        out[key] = dict(ms=ms, library_ms=lib_ms, lib_err=lib_err, bound=b,
                        graph_ms=g["cfir"], library_graph_ms=g["conv1d"],
                        host_paced_ms=paced, library_host_paced_ms=lib_paced,
                        shape=f"n={n} nt={nt} start={args[0]} step={args[1]}"
                              f" count={c}")
    R, n, nt = 128, 1 << 18, 65
    x = torch.randn((R, n), device=dev, generator=gen)
    taps = torch.randn(nt, device=dev, generator=gen)
    xp = F.pad(x, (nt - 1, 0))[:, None]
    wf = taps.flip(0).view(1, 1, -1)
    lib_err = float((F.conv1d(xp, wf)[:, 0] - fk.fir(x, taps)).abs().max())
    g = graph_ms({"conv1d": lambda: F.conv1d(xp, wf),
                  "fir": lambda: fk.fir(x, taps)}, reps=20)
    ms, lib_ms = (float(np.median(g[k])) for k in ("fir", "conv1d"))
    # The exact order's floor: one FMUL and one FADD per tap and output,
    # at 128 FP32 lanes per SM per clock.
    issue_ms = (2.0 * nt * R * n / (128 * torch.cuda.get_device_properties(
        0).multi_processor_count * max_sm_clock_hz()) * 1e3)
    out["fir"] = dict(ms=ms, library_ms=lib_ms, lib_err=lib_err,
                      bound=bound_ms(2 * R * n * 4 + nt * 4, 2.0 * nt * R * n),
                      graph_ms=g["fir"], library_graph_ms=g["conv1d"],
                      host_paced_ms=cuda_time(lambda: fk.fir(x, taps),
                                              reps=20),
                      library_host_paced_ms=cuda_time(
                          lambda: F.conv1d(xp, wf), reps=20),
                      fp32_issue_floor_ms=issue_ms,
                      shape=f"R={R} n={n} nt={nt}")
    for k, v in out.items():
        name = "fir" if k == "fir" else "cfir"
        timing = (f"device time per call from CUDA-graph replays in turns "
                  f"(conv1d, {name}, {name}, conv1d) x 3: {name} "
                  + " ".join(f"{t:.4f}" for t in v["graph_ms"])
                  + ", conv1d " + " ".join(f"{t:.4f}" for t in
                                           v["library_graph_ms"])
                  + f"; host-paced (back-to-back calls, CUDA events): "
                  f"{name} {v['host_paced_ms']:.4f}, conv1d "
                  f"{v['library_host_paced_ms']:.4f}"
                  + (f"; FP32-issue floor of the exact order "
                     f"{v['fp32_issue_floor_ms']:.4f} ms"
                     if "fp32_issue_floor_ms" in v else ""))
        print(f"kernel {k:14s} {v['shape']}: {v['ms']:.4f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}); conv1d "
              f"{v['library_ms']:.4f} ms (max |diff| {v['lib_err']:.3g}); "
              f"{timing}")
    return out


def seg_demod_times(captured, params, sym_consts, clock, chain):
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
        cb = chain_ms(n, chain, clock)
        out.append(dict(shape=f"C={C} nsamp={n}", ms=ms, bound_ms=b,
                        bound_by=by, **cb))
        print(f"kernel demod     C={C} nsamp={n} (segmented): {ms:.3f} ms, "
              f"bound {b:.4f} ms ({by}), serial chain bound "
              f"{cb['chain_bound_ms']:.3f} ms (the assumed count: "
              f"{cb['chain_bound_ms_assumed']:.3f})")
    return out


def fft_times(dev):
    """fft4096 at B=1024 beside its plain version and one torch.fft.fft
    (cuFFT) over the same frames as complex64, each over FFT_BUFFERS
    inputs in turn (6 x 32 MB, more than the 50 MB L2), so every call
    reads its input from device memory as the byte bound assumes. The
    kernel and cuFFT are timed in turns, three rounds: `ms` and
    `library_ms` are the medians (the table's), with each round kept.
    `ms_one_buffer` and `library_ms_one_buffer` repeat one input (which
    the L2 partly serves). Bound: 16 bytes per point (two planes in, two
    out) over the HBM rate against 5 N log2 N operations per frame at
    the float rate. Its own generator: the phases after it draw what
    they drew."""
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    B, N = 1024, ffk.N
    xs = [tuple(torch.randn((B, N), device=dev, generator=gen)
                for _ in range(2)) for _ in range(FFT_BUFFERS)]
    xcs = [(torch.complex(*x),) for x in xs]

    def rotating(fn, args, reps):
        i = [0]

        def call():
            fn(*args[i[0] % len(args)])
            i[0] += 1
        return cuda_time(call, reps=reps, warmup=len(args))

    rounds = [(rotating(ffk.fft4096, xs, 60), rotating(torch.fft.fft, xcs, 60))
              for _ in range(3)]
    ms, lib = (float(np.median(v)) for v in zip(*rounds))
    plain = rotating(ffk.fft4096_ref, xs, 12)
    ms1 = cuda_time(lambda: ffk.fft4096(*xs[0]), reps=50)
    lib1 = cuda_time(lambda: torch.fft.fft(*xcs[0]), reps=50)
    b, by = bound_ms(16.0 * B * N, 5.0 * N * np.log2(N) * B)
    print(f"kernel fft4096    B={B} ({FFT_BUFFERS} inputs in turn): "
          f"{ms:.4f} ms (rounds " + " ".join(f"{k:.4f}" for k, _ in rounds)
          + f"), bound {b:.4f} ms ({by}, {b / ms:.0%} of it); plain "
          f"{plain:.4f} ms; torch.fft.fft {lib:.4f} ms (rounds "
          + " ".join(f"{c:.4f}" for _, c in rounds) + f"); one input "
          f"repeated: {ms1:.4f} / torch.fft.fft {lib1:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                bound_by=by, shape=f"B={B}", rounds=rounds,
                ms_one_buffer=ms1, library_ms_one_buffer=lib1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from leansdr_tpu_torch import device as kdev
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
    probe_build = start_probe_build()
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

    clock = max_sm_clock_hz()
    lat, lat_int = latency_table(probe_build, dev)
    chain = demod_chain(built["demod"][0], lat, clock)
    a_chain = acs_chain(built["acs"][0], lat_int, clock)
    b_chain = banked_chain(built["acs_banked"][0], lat_int, clock)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    check_sincos(dev)
    d_err = 0.0
    d_plain = None
    for predef, rate, nsym, C, n in DEMOD_CHECKS:
        e, p = check_demod(predef, rate, nsym, C, n, dev, gen)
        d_err = max(d_err, e)
        if d_plain is None:
            d_plain = p
    a_err, a_plain = check_acs(dev, gen)
    long_acs = start_long_acs(dev, gen)
    b_err, b_plain, b_plain_n = check_acs_banked(dev, gen)
    long_banked = [start_long_banked(dev, gen, r) for r in PUNCTURED]
    f_err, f_plain_c, f_plain_r = check_fir(dev, gen)

    fft_err, fft_rel_plain, fft_rel_lib = check_fft(dev, gen)
    fft = fft_times(dev)
    check_first_argmax(dev, gen)

    # Phase 4: the fleet at each rate, sequential (segments=1) and
    # segmented (segments=8), on one stimulus per rate; at rate 1/2 also
    # the segment sweep and the segmented launches against demod_ref.
    frames = fleet_frames(dev, gen, "1/2")
    rx, run, piped_rate = main_path(dev, gen, frames)
    launches, stages, rate = run["launches"], run["stages"], run["rate"]
    times = kernel_times(rx, frames, dev, gen, chain, a_chain)
    params, sym_consts = rx.params, rx._sym_consts
    del rx
    seg = {"1/2": segmented_path(dev, frames, "1/2", 8, capture=True)}
    captured = seg["1/2"].pop("captured")
    seg_checks = seg_plain_checks(captured, params, sym_consts)
    print("[rate 1/2 S=8] demod launches of chunk "
          f"{SEG_CHUNKS - 1} == demod_ref on {SC_DEMOD_CHECK} samples: "
          + "; ".join(f"{c} lanes (plain {ms:.0f} ms)"
                      for c, ms in seg_checks))
    seg_times = seg_demod_times(captured, params, sym_consts, clock, chain)
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
    btimes = banked_times(dev, gen, b_chain, clock)
    b0 = btimes[0]                      # 3/4 ACQUIRE: the headline shape
    for job in [long_acs] + long_banked:  # before the host-timed streams
        finish_plain(job)
    rng = np.random.default_rng(SEED)
    stimuli = {}
    single = [single_carrier(dev, rng, stimuli, *p) for p in SC_PATHS]
    del stimuli
    ftimes = fir_times(dev, gen)
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
         "chain_bound_ms_assumed": times["demod"]["chain_bound_ms_assumed"],
         "chain_source": "tools/sass_chain.py on cuobjdump -sass of the "
                         "built demod (QPSK loop), latencies from "
                         "tools/latency_probe.cu on this card",
         "chain_cycles_per_sample": chain["cycles_per_step"],
         "issue_cycles_per_sample": chain["issue_cycles_per_step"],
         "chain_path_instructions": chain["path_instructions_per_step"],
         "hot_instructions_per_sample": chain["instructions_per_step"],
         "latency_cycles": lat,
         "wide_ms": times["demod_wide"]["ms"],
         "wide_shape": times["demod_wide"]["shape"],
         "one_ms": times["demod_one"]["ms"],
         "one_shape": times["demod_one"]["shape"],
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
         "track_bound_ms": times["acs_track"]["bound"][0],
         "sc_ms": times["acs_sc"]["ms"], "sc_shape": times["acs_sc"]["shape"],
         "cycles_per_block": {k: times[k]["cycles_per_block"]
                              for k in ("acs", "acs_track", "acs_sc")},
         "chain_bound_ms": {k: times[k]["chain_bound_ms"]
                            for k in ("acs", "acs_track", "acs_sc")},
         "chain_source": "tools/sass_chain.py on cuobjdump -sass of the "
                         "built acs (ACQUIRE and TRACK loops), latencies "
                         "from tools/latency_probe.cu on this card",
         "chain": {m: {k: r[k] for k in ("function", "cycles_per_step",
                                          "issue_cycles_per_step",
                                          "path_instructions_per_step",
                                          "instructions_per_step", "mix")}
                   for m, r in a_chain.items()},
         "latency_cycles": lat_int,
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
         "chain_source": "tools/sass_chain.py on cuobjdump -sass of the "
                         "built acs_banked (the block loop, the "
                         "shared-memory exchange counted), latencies from "
                         "tools/latency_probe.cu on this card",
         "chain": {B: {k: r[k] for k in ("function", "cycles_per_step",
                                          "issue_cycles_per_step",
                                          "instructions_per_step", "mix")}
                   for B, r in b_chain.items()},
         "ops_count": "banked_ops: 1 per candidate (fused add-min), 1 per "
                      "predecessor, 8 per row (9 at 7/8), 2 per block",
         "plain_shape": f"rate 3/4 N={b_plain_n} T=1024"},
        {"name": "cfir", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fir.cu",
         "replaces": "leansdr_tpu/dsp/fir_pallas.py:62",
         "launches": resample["launches"]["cfir"], "max_abs_err": f_err,
         "ms": ftimes["cfir_decimated"]["ms"], "plain_ms": f_plain_c,
         "bound_ms": ftimes["cfir_decimated"]["bound"][0],
         "bound_by": ftimes["cfir_decimated"]["bound"][1],
         "library_ms": ftimes["cfir_decimated"]["library_ms"],
         "shape": ftimes["cfir_decimated"]["shape"],
         "timing": "device time per call from CUDA-graph replays of 50 "
                   "calls, in turns with conv1d, median of 3 rounds",
         "graph_ms": ftimes["cfir_decimated"]["graph_ms"],
         "library_graph_ms": ftimes["cfir_decimated"]["library_graph_ms"],
         "host_paced_ms": ftimes["cfir_decimated"]["host_paced_ms"],
         "library_host_paced_ms":
             ftimes["cfir_decimated"]["library_host_paced_ms"],
         "full_rate": {k: ftimes["cfir"][k] for k in (
             "ms", "library_ms", "graph_ms", "library_graph_ms",
             "host_paced_ms", "library_host_paced_ms", "shape")}
         | {"bound_ms": ftimes["cfir"]["bound"][0],
            "bound_by": ftimes["cfir"]["bound"][1]},
         "plain_shape": "n=131157 nt=79 full rate"},
        {"name": "fir", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fir.cu",
         "replaces": "leansdr_tpu/dsp/fir_pallas.py:25",
         "launches": resample["launches"]["fir"], "max_abs_err": f_err,
         "ms": ftimes["fir"]["ms"], "plain_ms": f_plain_r,
         "bound_ms": ftimes["fir"]["bound"][0],
         "bound_by": ftimes["fir"]["bound"][1],
         "library_ms": ftimes["fir"]["library_ms"],
         "shape": ftimes["fir"]["shape"],
         "timing": "device time per call from CUDA-graph replays of 20 "
                   "calls, in turns with conv1d, median of 3 rounds",
         "graph_ms": ftimes["fir"]["graph_ms"],
         "library_graph_ms": ftimes["fir"]["library_graph_ms"],
         "host_paced_ms": ftimes["fir"]["host_paced_ms"],
         "library_host_paced_ms": ftimes["fir"]["library_host_paced_ms"],
         "fp32_issue_floor_ms": ftimes["fir"]["fp32_issue_floor_ms"],
         "plain_shape": "R=128 n=131157 nt=79"},
        {"name": "fft4096", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fft4096.cu",
         "replaces": "leansdr_tpu/dsp/fft_pallas.py:58",
         "launches": launches["fft4096"], "max_abs_err": fft_err,
         "ms": fft["ms"], "plain_ms": fft["plain_ms"],
         "bound_ms": fft["bound_ms"], "bound_by": fft["bound_by"],
         "library_ms": fft["library_ms"], "shape": fft["shape"],
         "rel_err_plain": fft_rel_plain, "rel_err_library": fft_rel_lib,
         "timing": f"{FFT_BUFFERS} inputs in turn (> L2), median of 3 "
                   "rounds in turns with torch.fft.fft",
         "rounds_ms_library_ms": fft["rounds"],
         "ms_one_buffer": fft["ms_one_buffer"],
         "library_ms_one_buffer": fft["library_ms_one_buffer"],
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
    if sys.argv[1:2] == ["--plain"]:         # start_plain's child
        plain_job(*sys.argv[2:4])
        sys.exit(0)
    sys.exit(main())
