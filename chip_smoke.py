#!/usr/bin/env python3
"""Smoke test of leansdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from leansdr_tpu_torch/csrc (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the fleet receiver's main path at full width — 64 QPSK carriers at
2 Msym/s sampled at 4 Msps, chunk_samples = 2**18, Viterbi on — at code
rate 1/2 (the rate-1/2 ACS kernel) and at the punctured rates 3/4 and 7/8
(the banked ACS kernel), each sequentially and with the time-segmented
demod (segments=8); the hard-decision fleet (Viterbi off: the device
GF(2) decode) at 1/2, 3/4 and 7/8, at 1/2 with segments=8 and with the
linear sampler; the exact-LUT fleet on the scan demod with the
polyphase rrc sampler (Viterbi at segments=1 and 8, hard decisions);
the fleet CLI leandvbfleet in a child process (no fastlock, --acq: the
fft4096 kernel); and the single-carrier receiver of leandvb on ten
streams (the CLI defaults, the same with --segments 8, --resample on
the complex FIR kernel, --hq at 1/2 and 3/4, and on the scan demods
--exact-lut, --exact-lut --sampler rrc, --hard-metric, --sampler
nearest and --hs), from DVB-S stimulus the port modulates itself; and
the canonical pipe `leantsgen | leandvbtx | leanchansim | leandvb` from
the port's own CLIs, the receiver's --awgn and its --hdlc; slice 8's
constellations and rates (the fleet at 8PSK 2/3, run as 4/6, and BPSK
1/2; leandvb --viterbi at 8PSK 2/3, BPSK 1/2, 32APSK 4/5, 16APSK 3/4),
--cnr --fd-spectrum and the fleet's preprocessing (anf, cnr, spectrum);
slice 9's device modulator (DeviceModulator at 1/2, 3/4, 7/8 and 8PSK
2/3 on 64 carriers' packets), the candidate scan (the reference's 4 SR x
5 CR grid on one 2 Msym/s rate-3/4 stream, in process and through
`leansdrscan --device`, on scan_demod's per-channel-omega mode) and the
FM multi-channel receiver (`leanmlmrx` over 201 channels at 25.6 Msps);
slice 10's torch.distributed modules (parallel/mesh.py, halo.py,
timeshard.py at one NCCL rank and at two gloo ranks sharing the card,
and `python -m leansdr_tpu_torch.parallel.multihost --world 2 --backend
gloo`) and the pinned-buffer ingest (util/ingest.DeviceFeeder); and
checks that every carrier locks and decodes the TS packets (or HDLC
frames) that were sent.

Phases (any failure exits non-zero):
  1. card name and power limit, versions, kernel build time; dependent
     instruction latencies on the card (tools/latency_probe.cu) and the
     serial chains of the demod (per sample, both QPSK loops: on the
     phase-error table and without it), of the ACS kernel (per
     trellis block, ACQUIRE and TRACK) and of the banked ACS kernel (per
     block at each B, through its shared-memory exchange and barrier)
     counted from their SASS (tools/sass_chain.py on `cuobjdump -sass` of
     the built libraries), each also as one warp issuing it in order;
  2. the demod's rotation (sincosf) == torch.cos / torch.sin bit for bit
     on all 65536 u16 angles; scan_demod == run_chunks_ref and hs_demod
     == run_chunks_hs_ref on every output and state plane (each sampler
     x decision mode, the rrc sampler at its 4 and 2.4 Msps geometries,
     a general tap count and taps past shared memory, and --hs at omega
     2.0 and 1.2, at C = 1, 37 and 64, cold and live state; the kernel
     leaves its input state as it was; the four sincos entries hs_demod
     takes from the table), and the scan demods' serial chains per
     emitted symbol from their SASS, their gathers priced at L1 and at L2
     hits (tools/latency_probe.cu's two pointer chases);
     the QPSK phase-error table the card fills == pe16_table_ref on all
     65536 entries; demod kernel == demod_ref, every packed
     word and every state plane bit for bit (DEMOD_CHECKS: QPSK at C=64
     and C=8192, 8PSK at C=64, 4096 samples; QPSK and 16APSK at C in
     {1, 33, 100} over 1024 samples and C=33 over 128, the ragged
     32-channel blocks and the copy ring's prologue and epilogue; BPSK,
     32APSK and 64APSKe at C=64 over 1024 samples; QPSK at 2^16 times
     the setpoint amplitude, where the table's off-grid fallback runs;
     DEMOD_LONG: the benchmark's launches, 14 lanes x 2^18 and one lane
     x 2^17 at omega 1.2; the plain version costs one launch per op per
     sample), each QPSK launch on the table where its 32-channel blocks
     fit on the SMs (C=8192 not, nor any other constellation);
     scan_demod also at 8PSK (linear
     sampler, both decision modes, C=64); scan_demod's per-channel-omega
     mode (slice 9) == run_chunks_ref bit for bit, each sampler x
     decision mode, at C=4 with the scan grid's omegas and C=64 with 64
     distinct ones, cold and live;
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
     plain version on the host CPU in a child process); and slice 8's
     instances: B=1 at the BPSK fleet's N=128, B=2 at N=16 and the 4/5
     tables at N=8 (T=128), the 8PSK fleet's 4/6 at N=2048, each also at
     BPSK's int16-sum cost extremes; the ACS at the BPSK single
     carrier's N=2;
     cfir == cfir_ref and fir == fir_ref bit for bit (nt 21, 79, 2048;
     lengths off the tile; fir also at its tile's edges, FIR_EDGE_*;
     from a zero head and mid-stream; cfir also
     decimated: the --resample stage's launch at its shape, ragged
     counts, other steps); fft4096
     within max|dy| / max|y| < 2e-5 of fft4096_ref and of torch.fft.fft
     at B=8, 1024 and 1064 (the sums run in other orders); torch.argmax takes
     the first maximum and torch.argmin the first minimum on the card, as
     the segmented demod and the hard decode's election need; after the
     rate-1/2 stimulus is made, fft4096 within 2e-5 of fft4096_ref at the
     --acq search's shape (64 frames of one carrier's first chunk raised
     to the 4th power) and coarse_carrier_estimate equal on the card and
     on the host's plain FFT;
  4. the main path through MultiDvbsReceiver.process, with the kernels'
     launch counters zeroed just before and read just after (every
     demod launch of the fleet at 1/2 and of the canonical stream on the
     phase-error table), and
     per-stage times from CUDA events; at rate 1/2 then the same stream
     through the pipelined submit()/flush() path (device->host copy and
     byte backend on threads), held to the same TS gate; then with
     segments=8 (seg_holdoff=2, 8 chunks: 5 timed segmented chunks; the
     demod's pass 1, pass 2 and the engine's own relabel/splice ops
     timed apart), the two demod launches of its last chunk against
     demod_ref bit for bit on their first 1024 samples, and the rate-1/2
     chain at segments 1, 2, 4, 8 and 16; then 64 carriers at 3/4 and at
     7/8, sequential and segments=8, each run with its own zeroed
     counters; the hard-decision fleet (viterbi=False, fastlock) at 1/2
     sequential, segments=8 and with the linear sampler, and at 3/4 and
     7/8 sequential, each with its own zeroed counters, stage times and
     the same gate, its first demod launch and one mid-stream launch
     against demod_ref bit for bit on 1024 samples; `python -m
     leansdr_tpu_torch.apps.leandvbfleet` in a child process on the
     first CLI_CHUNKS chunks of the 1/2 stimulus as interleaved f32 on
     stdin (64 carriers, the odd ones a quadrant on; --cr 1/2 --sampler
     rrc --acq --chunk 262144, no --fastlock: the framer's resyncs must
     reach the decoder), its multiplex
     parsed and gated per channel, its launch counts and two demod
     launches' inputs written by the child at exit and held against
     demod_ref here; the exact-LUT fleet (exact_lut=True, the polyphase
     rrc sampler in scan_demod, 499 taps in steps of 32) at 1/2 with
     Viterbi at S=1 and S=8 and with hard decisions, each with its own
     counters and gate, a first and a mid-stream scan launch against
     run_chunks_ref on SCAN_PLAIN samples, and scan_demod's and
     hs_demod's times at the main paths' shapes (SCAN_TIMED: the fleet's
     launch, the S=8 fleet's pass 2, one carrier's read at 4 and 2.4
     Msps; hs_demod at omega 2.0 and 1.2); then the single-carrier
     receiver (leandvb's DvbsReceiver,
     in its 2^17-sample reads) on ten streams, each with its own zeroed
     counters: rtl_sdr u8 at 2.4 Msps with a birdie (the CLI defaults:
     notch, hard decisions), the same bytes with --segments 8, a 10 Msps
     s16 333 ksym/s carrier through --resample (cfir), --hq at 1/2
     and 3/4 on 4 Msps f32 (the ACS kernels), the canonical bytes with
     --exact-lut, --exact-lut --sampler rrc, --hard-metric and --hs, and
     --sampler nearest on 8 Msps u8; each must lock and decode
     >= 90% of the packets sent after lock; per-stage times, input
     Msamples/s and x real time; after each stream, the inputs of its
     first launch of every kernel and of one launch mid-stream (a live
     state; with --segments both passes of one read) go through the
     kernel and its plain version again, equal bit for bit (the demod on
     the first 1024 samples of the read: its plain version costs ~3 ms
     per sample on the card); then ROADMAP item 24's brick-wall stimulus
     on the kernel path and the exact-LUT polyphase path (MER and lock
     printed, not a gate); then the canonical pipe (pipe_path: leantsgen
     -c 2000 | leandvbtx -f 2 --cr 1/2 | leanchansim --if32 --of32 --awgn
     -14 --deterministic | leandvb --f32 --float-scale 75 -f 4e6 --sr 2e6
     --anf 0 --fastlock, each stage a child process, leandvb on the card
     writing its launch counts at exit; each stage alone and the whole
     pipe timed; lock, the demod launched, >= 90% of the packets sent
     after lock), the receiver's --awgn (Es/N0 12 dB on a clean 4 Msps
     stream, beside the same stream without it: the MER it costs) and
     --hdlc --packetized (random frames, HDLC-framed, ETR192-scrambled,
     rate 1/2; >= 90% of the frames sent after lock; the descrambler's
     and the HDLC sync's host times), each gated and replayed against
     the plain versions as the other single-carrier streams; slice 8
     (FLEET_PATHS_8, SC_PATHS_8): the fleet at 8PSK 2/3 (as 4/6, 2048
     ACQUIRE lanes) and BPSK 1/2 (the B=1 instance), the QPSK fleet with
     anf=1, cnr and want_spectrum at 1 Msps per carrier (its notch, CNR
     and spectrum host ms per chunk; one CNR vector and one spectrum line
     per Fs samples); leandvb --viterbi --fastlock --anf 0 at 8PSK 2/3,
     BPSK 1/2, 32APSK 4/5 and 16APSK 3/4 (1 s at 4 Msps f32), and --cnr
     --fd-spectrum on 2.5 s at 4.8 Msps u8, whose CNR values and
     spectrum lines equal a CPU run of the same estimators on the same
     samples within 0.01 dB; each with the gate above, but for the fleet
     8PSK, whose partial lock the JAX fleet shares (ROADMAP queue 3): its
     lock and packets printed, its gate the run through the kernels and
     the kernels' checks. A 32APSK stream that does not lock passes only
     by the half-turn twin rule (twin_replay, queue 3): its elected sync
     ties the twin in every chunk, and with the twin pinned it locks and
     decodes the packets; slice 9: the device modulator on the card at
     QPSK 1/2, 3/4, 7/8 and 8PSK 2/3 over 64 carriers' packets
     (Msamples/s out; carriers 0 and 63 equal to the same function on
     the CPU and within 1e-5 of the host modulator); the candidate scan,
     2 s of u8 at 2.4 Msps (2 Msym/s, rate 3/4, the canonical fold-back
     front end) on the 4 SR x 5 CR grid in process
     (CandidateScanReceiver, its counters zeroed, 2^16-sample reads, then
     focus()) and through `leansdrscan --device` without --rewind in a
     child process, each electing (2e6, 3/4) and decoding >= 90% of the
     packets after lock, two scan launches against run_chunks_ref, time
     to election and x real time; `leanmlmrx` over 201 channels
     (87.6-107.6 MHz, --squelch 0.8) on 1 s of s16 at 25.6 Msps in a
     child process, its audio equal to the in-process MlmReceiver's,
     each toned channel alone peaking at its tone within 50 Hz, a dead
     channel squelched silent, the card's audio on a prefix equal to a
     CPU run within 1 LSB at under 1 in 10^3 samples; x real time,
     channelize's and the host stages' ms; slice 10 (multi_path, from
     SEED_10): at one NCCL rank the sharded demod step (scan_demod over
     64 carriers x 2^18, rrc exact) and the sharded FIR (fir over 2^24
     complex samples) equal to their unsharded runs (and fir_ref); two
     gloo ranks on the card (`--multi-rank` children): the halo equal to
     the unsharded FIR and the ring over 2 carriers equal to the
     unsharded run_chunks in every output and its end state; the
     multihost launcher's 64-carrier rate-1/2 fleet, 32 carriers per
     rank, its TS equal to the single-process fleet's fed through
     DeviceFeeder, which locks every carrier and decodes >= 90% of the
     packets after lock; DeviceFeeder over 16 chunks of 64 x 2^18
     checked on the card, the consumer's wait per chunk, and the
     host-to-device rate from pinned and from pageable memory;
  5. kernel times at the main path's shapes (the demod also at the
     segmented launches' shapes and at one carrier; the ACS at N=256,
     N=64 and N=4; the banked ACS at every rate's ACQUIRE and TRACK
     lanes and the hq 3/4 launch, with cycles per block beside its SASS
     chain and in-order issue), bounds (the demod's and the ACS's serial
     bounds from phase 1), one `kernels` line (cfir full rate and
     decimated, and fir, beside one conv1d computing the same FIR, TF32
     off, each with its conv1d as device time from CUDA-graph replays in
     turns and as host-paced calls; fft4096 beside one torch.fft.fft, in turns over
     inputs that exceed the L2, timed in phase 3 right after its check;
     scan_demod's per-channel mode at the scan path's launch, C=4);
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

from leansdr_tpu_torch.util import trace

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
# Slice 8: the constellations new to the receivers' paths (check_slice8).
DEMOD_CHECKS_8 = (("BPSK", "1/2", 2, NCHAN, 1024),
                  ("APSK32", "4/5", 32, NCHAN, 1024),
                  ("APSK64E", "2/3", 64, NCHAN, 1024))
# Slice 8's checks and paths draw from their own seeds (a torch
# generator and a NumPy one), so that every earlier path reads the same
# stimulus as before slice 8.
SEED_8 = SEED + 8
# Slice 9 (the device modulator, the candidate scan, the FM receiver)
# likewise, from SEED + 9.
SEED_9 = SEED + 9
# Slice 10 (multi-GPU and host ingest: multi_path) likewise, from
# SEED + 10.
SEED_10 = SEED + 10
# The demod's phase-error table checks (the off-grid and DEMOD_LONG
# stimuli) likewise, from SEED + 11.
SEED_PE = SEED + 11
# The candidate scan's grid: the reference's 4 SR x 5 CR at 2.4 Msps
# (SURVEY.md:251, `leansdrscan leandvb --sr a,b,c,d --cr ...`): 20
# candidates on 4 scan lanes.
SCAN_FS = 2.4e6
SCAN_SRS = (250e3, 333e3, 1e6, 2e6)
SCAN_CRS = ("1/2", "2/3", "3/4", "5/6", "7/8")
# The per-channel scan demod against its plain version at these channel
# counts: the grid's 4 lanes (its omegas) and 64 distinct omegas.
SCAN_PC_C = (4, 64)
# The demod's serial bound is counted from the built kernel's SASS
# (tools/sass_chain.py on `cuobjdump -sass`: the instructions on the
# QPSK loop's loop-carried path, each at its latency as
# tools/latency_probe.cu measures it on this card). It supersedes an
# assumed count, 90 dependent operations per sample at 4 cycles, still
# printed beside it.
ASSUMED_CHAIN_CYCLES = 90 * 4
# The demod's two QPSK loops: demod_kernel<true, true> takes the phase
# error from its table (every main path), demod_kernel<true, false> is the
# layout without it (a launch whose blocks exceed one wave). Each loop is
# the smallest holding the packed word's STS and truncf's FRND (the table
# instance's loop holds no MUFU: its division is out of line).
DEMOD_QPSK_FUNCTIONS = {"table": "demod_kernelILb1ELb1E",
                        "no table": "demod_kernelILb1ELb0E"}
DEMOD_LOOP_ALSO = "FRND"
# The demod against demod_ref at the benchmark's main launches, on random
# QPSK at the sample rate's samples per symbol: (lanes, samples, omega):
# the 14-carrier fleet's chunk and one leandvb read at 2.4 Msps (the plain
# version takes ~1.7 ms a sample on the card: ~11 min together).
DEMOD_LONG = ((14, 1 << 18, 2.0), (1, 1 << 17, 1.2))
# The table's fallback: the fleet's lanes at this many times the AGC's
# setpoint amplitude, where the halving cap of 12 binds from the cold
# state (gain 1) until the AGC has come down.
DEMOD_OFF_GRID = (14, 1024, 2.0 ** 16)
TOOLS = Path(__file__).resolve().parent / "tools"
LATENCY_PROBES = 26                           # tools/latency_probe.cu
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
SC_LIVE_LAUNCH = {"demod": 20, "cfir": 20, "acs": 4000, "acs_banked": 4000,
                  "scan_demod": 20, "hs_demod": 20}
SC_DEMOD_CHECK = 1024
# The scan demods (slice 6) against their plain versions: every sampler
# x decision mode (and --hs) at these channel counts (37: a ragged last
# block) over SCAN_CHUNKS chunks, from the cold state and again from the
# kernel's end state; the fleet's main-path launches on their first
# SCAN_PLAIN samples.
SCAN_CHECK_C = (1, 37, NCHAN)
SCAN_CHUNKS = 2
SCAN_PLAIN = 256
# The rrc geometries held against the twin: (label, sample rate, RxConfig
# fields): the fleet's at 4 Msps (499 coefficients in steps of 32, 16 taps
# per window), the 2.4 Msps stream's (497 in 53, 10 taps), a tap count
# with no instance of its own (rrc_rej 15: 251 in 32, 8 taps; the general
# shared-memory instance) and taps that do not fit beside the input ring
# (rrc_steps 2048: 31917 in 2048, 16 taps; the device-memory instance).
SCAN_RRC = (("rrc", 4e6, {}), ("rrc 2.4 Msps", 2.4e6, {}),
            ("rrc rej 15", 4e6, {"rrc_rej": 15.0}),
            ("rrc steps 2048", 4e6, {"rrc_steps": 2048}))
# The scan kernels' sample loops in SASS: scan_kernel<SAMPLER, EXACT, NT,
# SUB, TAPS_SHARED> by its mangled name, the instances the timed shapes
# run (SCAN_TIMED). The loop is the smallest one holding the packed
# word's STG and FMNMX (mucorr's clamp; the rrc re-shift loop holds
# neither).
SCAN_FUNCTIONS = {
    "nearest exact": "scan_kernelILi0ELb1ELi0ELi0ELb0E",
    "linear exact": "scan_kernelILi1ELb1ELi0ELi0ELb0E",
    "linear computed": "scan_kernelILi1ELb0ELi0ELi0ELb0E",
    "rrc exact": "scan_kernelILi2ELb1ELi16ELi32ELb1E",
    "rrc exact 2.4 Msps": "scan_kernelILi2ELb1ELi10ELi53ELb1E",
}
# Item 24's stimulus (ROADMAP): a 2 Msym/s rate-1/2 carrier at 2.4 Msps
# behind a brick-wall front end, resample_poly(z, 6, 5), no noise.
BRICKWALL_SAMPLES = 1 << 21
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
# The fleet CLI's run: chunks of the rate-1/2 stimulus on its stdin, the
# child's demod calls whose inputs it keeps (the first and one
# mid-stream), and the least sent packets per channel its gate asks for
# (a carrier whose PLL locked a quadrant off waits for three failed
# bit-phase sweeps of the framer, ~39 kB, before its resync).
CLI_CHUNKS = 8
CLI_CAPTURE = (0, 4)
CLI_MIN_PACKETS = 50
# Slice 7's paths: the canonical pipe's TS packets from leantsgen (2 Msym/s
# rate 1/2 at 4 Msps: ~1.6 s of signal) and its leanchansim noise (dB);
# the receiver's own --awgn at this Es/N0 (dB) on a clean stream; --hdlc
# on seconds of one carrier of random frames of these lengths (bytes).
PIPE_PACKETS = 2000
PIPE_AWGN_DB = -14
PIPE_TIMEOUT_S = 300             # each stage alone, and the whole pipe
AWGN_ESN0_DB = 12.0
AWGN_SECONDS = 1.0
HDLC_SECONDS = 1.0
HDLC_FRAME_BYTES = (32, 256)
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


# Float32 operations per SASS instruction that step_flops counts (FFMA is
# two). Compares, conversions, integer and memory instructions are not
# counted, so an operations bound built on it is a lower bound.
FLOPS_PER_INSTR = {"FADD": 1, "FMUL": 1, "FMNMX": 1, "FFMA": 2}


def step_flops(chain: dict) -> float:
    """Float32 operations per step of a kernel's hot path, from its SASS
    (the instruction mix tools/sass_chain.py reads over the unrolled loop
    body; blocks it leaves out, such as the computed decision's symbol
    loop, are not counted)."""
    return sum(chain["mix"].get(k, 0) * v
               for k, v in FLOPS_PER_INSTR.items()) / chain["unroll"]


def scan_table_bytes(tables: dict, p) -> int:
    """Bytes of the tables a scan_demod instance reads: the constellation
    rows (sym3) always; the trig16 table and the three LUT planes only on
    the exact-LUT route (the computed route takes its sincos and decision
    from arithmetic); the rrc prototype taps on the rrc sampler."""
    keys = ["sym3"] + (["trig", "lut_cost", "lut_symbol", "lut_phase"]
                       if p.exact_lut else [])
    return (sum(tables[k].numel() * tables[k].element_size() for k in keys)
            + (len(p.rrc_coeffs) * 4 if p.sampler == "rrc" else 0))


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
    less the partner; F2I and I2F(P) half their pair; LDG a load that hits
    L1 (the scan demods' table gathers) and LDG.L2 one that hits L2 (no
    SASS opcode reads that key: scan_chain prices LDG with it to bound a
    chain whose gathers miss L1). Returns (the
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
     sel, isetp_sel, redux, xchg_bar, xchg_warp, viaddmnmx, ldg, ldg_l2) = (
        cyc.cpu().double() / lib.probe_rep()).tolist()
    lat = {"fixed": max(fadd, fmul, ffma, fmnmx, fsel, shf, imad),
           "FSETP": fsetp_fsel - fsel, "F2I": conv_pair / 2,
           "I2F": conv_pair / 2, "I2FP": conv_pair / 2, "FRND.TRUNC": trunc,
           "FRND.FLOOR": floor, "FRND": max(trunc, floor),
           "MUFU.RCP": rcp_fadd - fadd, "MUFU.SIN": sin_pair - fmul,
           "MUFU.COS": sin_pair - fmul, "MUFU.RSQ": rsq_fadd - fadd,
           "LDS": lds, "LDG": ldg, "LDG.L2": ldg_l2}
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
    (tools/sass_chain.py on each QPSK loop of `cuobjdump -sass`):
    {"table": ..., "no table": ...} (DEMOD_QPSK_FUNCTIONS)."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    text = sass_of(so)
    out = {}
    for key, fn in DEMOD_QPSK_FUNCTIONS.items():
        res = out[key] = sass_chain.analyse(text, fn, lat, "STS",
                                            DEMOD_LOOP_ALSO)
        lds = res["path_mix"].get("LDS.S16", (0.0, 0.0))
        print(f"demod serial chain [{key}] (tools/sass_chain.py on "
              f"cuobjdump -sass {so.name}, QPSK loop {res['loop'][0]}-"
              f"{res['loop'][1]}): {res['path_instructions_per_step']:.0f} "
              f"instructions on the loop-carried path, "
              f"{res['cycles_per_step']:.1f} cycles per sample "
              f"({res['cycles_per_step'] / clock * 1e9:.1f} ns at "
              f"{clock / 1e6:.0f} MHz; assumed before: "
              f"{ASSUMED_CHAIN_CYCLES}), the table load {lds[1]:.1f} of "
              f"them; {res['instructions_per_step']:.0f} hot-path "
              f"instructions per sample, {res['issue_cycles_per_step']:.1f} "
              f"cycles per sample issued in order by one warp; on the "
              f"path: " + ", ".join(f"{k} {n:g}x {c:.1f}" for k, (n, c)
                                     in res["path_mix"].items())
              + f"; priced as fixed-pipe: "
              f"{', '.join(res['priced_as_fixed'])}")
    return out


# ---------------------------------------------------------------- phase 2

def demod_stimulus(predef, rate, C, nsamp, dev, gen):
    """[C, nsamp+1, 2] float32 on dev at the AGC setpoint amplitude:
    QPSK from the port's own modulator, other constellations as noisy
    random symbols; per-channel sample offsets, fractional delays and
    noise from the seeded generator."""
    from leansdr_tpu_torch.dsp.cstln import make_dvbs2_constellation
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    if getattr(predef, "name", predef) == "QPSK" and rate == "1/2":
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


def check_demod(name, rate, nsym, C, nsamp, dev, gen, x=None, omega=2.0,
                 label=""):
    """The demod kernel against demod_ref from the cold-start state, on
    demod_stimulus unless `x` is given: every packed word and every state
    plane equal, and the launch on the phase-error table exactly where
    use_pe_table says. Returns (state max |diff|, plain ms)."""
    from leansdr_tpu_torch.dsp import receiver, receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    predef = Predef[name]
    cst = make_dvbs2_constellation(predef, rate)
    params = receiver.ReceiverParams(omega=omega, sampler="linear",
                                     nsymbols=nsym, exact_lut=False,
                                     pll_adjustment=1.0 / 6)
    sc = rk.sym_constants(cst)
    if x is None:
        x = demod_stimulus(predef, rate, C, nsamp, dev, gen)
    planes = rk.pack_state(receiver.init_state(params, C, dev))
    base = trace.counters()
    st_k, pk_k = rk.demod(params, sc, planes, x)
    table = trace.counters().get(DEMOD_PE_COUNTER, 0) - base.get(
        DEMOD_PE_COUNTER, 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = int(rk.use_pe_table(rk.is_qpsk_grid(*sc[:2]), C, sms))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_r, pk_r = rk.demod_ref(params, sc, planes, x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    words = int((pk_k != pk_r).sum())
    planes_equal = torch.equal(st_k, st_r)
    nvalid = int(((pk_r >> 24) & 1).sum())
    err = float((st_k - st_r).abs().max())
    print(f"demod {name:6s} C={C:5d} nsamp={nsamp}{label} "
          f"[{'table' if table else 'no table'}]: valid symbols "
          f"{nvalid}, differing words {words}, state planes bit-equal "
          f"{planes_equal} (max |d| {err:.3g}), plain {plain_ms:.0f} ms")
    if words or not planes_equal or nvalid < C * nsamp // 4:
        fail(f"demod kernel != demod_ref ({name}, C={C}, "
             f"nsamp={nsamp}{label})")
    if table != want:
        fail(f"demod {name} C={C}: {table} launches on the phase-error "
             f"table, {want} expected")
    return err, plain_ms


def check_pe_table(dev):
    """The QPSK phase-error table the card filled (the wrapper's cache)
    against pe16_table_ref on all 65536 (i8, q8), bit for bit."""
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    phases = rk.sym_constants(make_dvbs2_constellation(Predef.QPSK,
                                                       "1/2"))[2]
    card = rk._pe_table(phases, dev).cpu()
    bad = int((card != rk.pe16_table_ref(phases)).sum())
    print(f"demod phase-error table (the card's fill) == pe16_table_ref on "
          f"all {card.numel()} (i8, q8): {bad} differing entries")
    if bad:
        fail(f"the card's phase-error table differs from pe16_table_ref "
             f"in {bad} entries")


def check_demod_off_grid(dev, gen):
    """The table instance where the halving cap binds: the fleet's lanes
    at DEMOD_OFF_GRID's amplitude, held against demod_ref; the samples
    off the grid at the cold state's gain of 1 (before the AGC comes down)
    are counted on the host to show the fallback is taken."""
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.dsp.cstln import Predef
    C, n, scale = DEMOD_OFF_GRID
    x = demod_stimulus(Predef.QPSK, "1/2", C, n, dev, gen) * scale
    i8, q8 = rk.quantize_s8(x[:, :rk.CHUNK, 0], x[:, :rk.CHUNK, 1])
    off = int((~((i8 >= -128) & (i8 <= 127) & (q8 >= -128)
                 & (q8 <= 127))).sum())
    if off == 0:
        fail("the off-grid demod check put no sample off the grid")
    return check_demod("QPSK", "1/2", 4, C, n, dev, gen, x=x,
                       label=f" x{scale:g} ({off} of the first chunk's "
                             f"{C * rk.CHUNK} samples off the grid)")


def qpsk_at(C: int, n: int, gen, sps: float) -> torch.Tensor:
    """[C, n+1, 2]: random QPSK at `sps` samples per symbol (linear
    interpolation), amplitude ~75, per-carrier fractional delays, carrier
    offsets ((c % 64) - 32) * 5e-6 cycles per sample (the fleet
    stimulus's; they move the trig16 index as a real carrier does),
    noise."""
    dev = gen.device
    sym = (torch.randint(0, 2, (C, int(n / sps) + 3, 2), device=dev,
                         generator=gen) * 2 - 1).float() * 53.0
    d = torch.rand((C, 1), device=dev, generator=gen)
    t = torch.arange(n + 1, device=dev)[None, :] / sps + d
    i = t.long()
    f = (t - i)[..., None]
    x = (1 - f) * torch.gather(sym, 1, i[..., None].expand(-1, -1, 2)) \
        + f * torch.gather(sym, 1, (i + 1)[..., None].expand(-1, -1, 2))
    off = ((torch.arange(C, device=dev) % 64) - 32).double() * 5e-6
    ang = (2 * np.pi * off[:, None] * torch.arange(
        n + 1, device=dev).double()).float()
    z = torch.complex(x[..., 0], x[..., 1]) * torch.polar(
        torch.ones_like(ang), ang)
    x = torch.stack([z.real, z.imag], -1)
    return (x + 6.0 * torch.randn(x.shape, device=dev, generator=gen)
            ).contiguous()


def check_demod_long(dev, gen):
    """The demod at the benchmark's main launches (DEMOD_LONG: the fleet's
    14-lane chunk, one 2.4 Msps read) against demod_ref on every word and
    state plane. Returns the plain version's ms by shape."""
    out = {}
    for C, n, omega in DEMOD_LONG:
        x = qpsk_at(C, n, gen, omega)
        _, ms = check_demod("QPSK", "1/2", 4, C, n, dev, gen, x=x,
                            omega=omega, label=f" omega {omega:g}")
        out[f"C={C} nsamp={n}"] = ms
    return out


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


def sc_lanes(rate, dev, const="QPSK"):
    """The single-carrier decoder's replica lanes (nsyncs) at trellis
    rate `rate` on `const`."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec.viterbi import ViterbiSyncDevice
    return ViterbiSyncDevice(make_dvbs2_constellation(Predef[const], rate),
                             rate, device=dev).nsyncs


def fleet_plan(rate, dev, const="QPSK"):
    """The ACQUIRE ViterbiPlan of the 64-carrier main path at trellis
    rate `rate` on `const`."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec import viterbi_device as vd
    return vd.MultiViterbiSync(make_dvbs2_constellation(Predef[const], rate),
                               rate, NCHAN, CHUNK_SAMPLES, 2.0,
                               device=dev).plan


def banked_costs(kind, rate, T, N, dev, gen):
    """Banked ACS block costs [T, N] int32: "ties", 0, -3, -6 or -9
    (metric ties on most blocks); "int16", the sum of the rate's nshifts
    symbols' costs (bits_out / 2 QPSK symbols per block, at least one),
    each at the callers' extremes -2^15, 2^15 - 1, 0 or anything between
    (acs_costs): the headroom of the kernel's normalisation; "bpsk16",
    the same over BPSK's bits_out symbols per block, the most any
    constellation puts in a block."""
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    if kind == "ties":
        return -3 * torch.randint(0, 4, (T, N), device=dev,
                                  dtype=torch.int32, generator=gen)
    bits_out = make_trellis(rate).bits_out
    return sum(acs_costs("int16", T, N, dev, gen) for _ in range(
        bits_out if kind == "bpsk16" else max(1, bits_out // 2)))


def check_slice8(dev, gen):
    """Slice 8's kernel checks, from their own generator: the demod at
    DEMOD_CHECKS_8 (BPSK, 32APSK, 64APSKe at C=64); acs at the BPSK
    single carrier's 2 lanes (T=128, ties, from zero and live);
    acs_banked at the instances and tables slice 8 brought, at the shapes
    its paths give them (B=1 at the BPSK fleet's 128 lanes, B=2 at the
    8PSK single carrier's 16, the 4/5 tables at the 32APSK single
    carrier's 8, 4/6 at the 8PSK fleet's 2048; T=1024 at N=200), with
    ties and at BPSK's int16-sum extremes (bits_out symbols per block);
    scan_demod at 8PSK (check_scan_8psk). Returns (max |diff| over all,
    plain ms by check)."""
    from leansdr_tpu_torch.fec import viterbi_device as vd
    err, plain = 0.0, {}
    for c in DEMOD_CHECKS_8:
        e, plain[f"demod {c[0]}"] = check_demod(*c, dev, gen)
        err = max(err, e)
    N = sc_lanes("1/2", dev, "BPSK")
    z = torch.zeros((64, N), dtype=torch.int32, device=dev)
    m0, p0 = z, z
    for rnd in range(2):
        cs = torch.randint(0, 4, (128, N), device=dev, dtype=torch.int32,
                           generator=gen)
        cost = acs_costs("ties", 128, N, dev, gen)
        k = vd.viterbi_acs("1/2", m0, p0, cs, cost)
        r = vd.viterbi_acs_ref("1/2", m0, p0, cs, cost)
        for name, a, b in zip(("metric", "path", "us", "q"), k, r):
            if not torch.equal(a, b):
                fail(f"ACS N={N} (BPSK single carrier) round {rnd}: {name} "
                     f"differs in {int((a != b).sum())} entries")
        print(f"acs N={N} T=128 (BPSK single carrier) round {rnd}: "
              "bit-equal")
        m0, p0 = k[0], k[1]
    n_fleet8 = fleet_plan("4/6", dev, "PSK8").n_lanes
    n_sc8, n_sc32 = sc_lanes("2/3", dev, "PSK8"), sc_lanes("4/5", dev,
                                                           "APSK32")
    e, _, _ = banked_cases([
        ("1/2", ((fleet_plan("1/2", dev, "BPSK").n_lanes, 1024, "ties"),
                 (NCHAN, 1024, "ties"), (200, 1024, "ties"),
                 (2 * NCHAN, 1024, "bpsk16"))),
        ("2/3", ((n_sc8, 128, "ties"), (n_sc8, 128, "bpsk16"),
                 (200, 1024, "ties"))),
        ("4/5", ((n_sc32, 128, "ties"), (n_sc32, 128, "bpsk16"),
                 (200, 1024, "ties"))),
        ("4/6", ((n_fleet8, 1024, "ties"), (n_fleet8, 1024, "bpsk16")))],
        dev, gen)
    err = max(err, e)
    plain.update(check_scan_8psk(dev, gen))
    return err, plain


def check_acs_banked(dev, gen):
    """acs_banked == viterbi_acs_banked_ref bit for bit at every QPSK
    fleet punctured rate: T=1024 at the fleet main path's lane counts (the
    rate's ACQUIRE lanes, 64 carriers x nsyncs, and TRACK's 64) and at
    N=200 (not a multiple of 32), coarse costs forcing metric ties; T=128
    (one single-carrier chunk) at the single carrier's nsyncs lanes; and
    the int16-sum cost extremes at the fleet's ACQUIRE and TRACK lanes;
    round 0 from zero planes, round 1 from the kernel's end state (slice
    8's instances: check_slice8). Returns (max |diff|, plain ms at 3/4
    ACQUIRE round 0, its N)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    n_acq_34 = fleet_plan("3/4", dev).n_lanes
    cases = [(rate, ((n_acq, 1024, "ties"), (NCHAN, 1024, "ties"),
                     (200, 1024, "ties"), (sc_lanes(rate, dev), 128, "ties"),
                     (n_acq, 1024, "int16"), (NCHAN, 1024, "int16")))
             for rate, n_acq in ((r, fleet_plan(r, dev).n_lanes)
                                 for r in vb.QPSK_PUNCTURED)]
    return banked_cases(cases, dev, gen, n_acq_34)


def banked_cases(cases, dev, gen, n_acq_34=None):
    """acs_banked == viterbi_acs_banked_ref bit for bit on `cases`:
    [(rate, [(N, T, costs kind)])], each shape twice, from zero planes
    and from the kernel's end state. Returns (max |diff|, plain ms and N
    of the first 3/4 round at N = n_acq_34)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec.viterbi import make_trellis
    err, plain = 0.0, None
    for rate, shapes in cases:
        ncs = make_trellis(rate).ncs
        for N, T, costs in shapes:
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
                if (rate == "3/4" and N == n_acq_34 and rnd == 0
                        and plain is None):
                    plain = (plain_ms, N)
                planes = k[:3]
    return (err,) + (plain or (None, None))


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


def check_first_argmin(dev):
    """The hard decode's election takes the FIRST least disagreement
    count (torch.argmin over the 4*A hypotheses), as jnp.argmin does:
    held on the card at the fleet's shapes (C=64 channels x E=32
    sub-blocks x 4, 8 and 16 hypotheses), with many ties. Its own
    generator: the later phases draw what they drew."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    for nhyp in (4, 8, 16):
        a = torch.randint(0, 3, (NCHAN, 32, nhyp), device=dev,
                          dtype=torch.int32, generator=gen)
        got = torch.argmin(a, dim=2).cpu().numpy()
        want = np.argmin(a.cpu().numpy(), axis=2)
        if not (got == want).all():
            fail(f"torch.argmin on the card does not take the first "
                 f"minimum ({int((got != want).sum())} of {got.size})")
    print("argmin on the card takes the first minimum (as jnp.argmin)")


def check_acq_fft(dev, frames):
    """fft4096 against fft4096_ref at the --acq search's shape: channel
    0's first chunk (float_scale undone), raised to the 4th power, as 64
    frames of 4096; and coarse_carrier_estimate on the card (the kernel)
    equal to the estimate through the plain FFT on the host. Returns the
    relative error."""
    from leansdr_tpu_torch.dsp import acquisition as acq
    from leansdr_tpu_torch.dsp import fft_kernel as ffk
    x = (frames[0, :CHUNK_SAMPLES] / 75.0).contiguous()
    zr, zi = x[:, 0], x[:, 1]
    for _ in range(2):
        zr, zi = zr * zr - zi * zi, 2 * zr * zi
    zr, zi = zr.reshape(-1, ffk.N), zi.reshape(-1, ffk.N)
    y = torch.complex(*ffk.fft4096(zr, zi))
    r = torch.complex(*ffk.fft4096_ref(zr, zi))
    rel = float((y - r).abs().max() / r.abs().max())
    est = acq.coarse_carrier_estimate(x, device=dev)
    est_plain = acq.coarse_carrier_estimate(x.cpu(), device="cpu")
    print(f"fft4096 at the --acq shape B={zr.shape[0]}: max|dy|/max|y| "
          f"{rel:.3g} against fft4096_ref; coarse estimate {est:.6g} "
          f"cycles/sample on the card, {est_plain:.6g} on the host")
    if not rel < FFT_BAR:
        fail(f"fft4096 at the --acq shape: {rel:.3g} >= {FFT_BAR}")
    if est != est_plain:
        fail(f"coarse_carrier_estimate: {est} on the card != {est_plain}")
    return rel


# ---------------------------------------------------------------- phase 4

def fleet_stimulus(dev, gen, nsamp, rate="1/2", const="QPSK", esn0_db=12.0,
                   interp=2):
    """[64, nsamp, 2] float32 on dev: channel c carries the port's
    modulation (constellation `const`, `interp` samples per symbol) at
    code rate `rate` of TS packets numbered from 1000*c, with its own
    fractional delay, carrier offset and AWGN (Es/N0 `esn0_db`, as if
    at 2 samples per symbol)."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec.convenc import FEC_SPECS
    from leansdr_tpu_torch.fec.viterbi_banked import viterbi_rate
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    cst = make_dvbs2_constellation(Predef[const], rate)
    bits_in, bits_out = FEC_SPECS[viterbi_rate(rate, cst.nsymbols)]
    # A TS packet takes at least 188*8 * bits_out/bits_in coded bits,
    # bits_per_symbol a symbol of `interp` samples, so these cover nsamp.
    npkt = (nsamp * cst.bits_per_symbol * bits_in
            // (1504 * bits_out * interp) + 16)
    rows = []
    for c in range(NCHAN):
        q = dvbs_tx.modulate(tsgen.generate(npkt, start=1000 * c),
                             dvbs_tx.TxConfig(constellation=Predef[const],
                                              rate=rate, interp=interp))
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
    sigma = rms * 10 ** (-esn0_db / 20) / np.sqrt(2)
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


def fleet_rx(dev, code_rate, viterbi=True, sampler="rrc", exact=False,
             const="QPSK", fields=None, **seg):
    """The 64-carrier fleet receiver of the main path at `code_rate`
    (viterbi=False: the hard-decision fleet; exact: the scan demod's
    exact-LUT route, with "rrc" its polyphase sampler; const: the
    constellation's Predef name; fields: other RxConfig fields; seg:
    MultiDvbsReceiver's segments, seg_warmup, seg_holdoff)."""
    from leansdr_tpu_torch.dsp.cstln import Predef
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    cfg = RxConfig(**(dict(Fs=4e6, Fm=2e6, rate=code_rate, fastlock=True,
                           float_scale=75, exact_lut=exact, viterbi=viterbi,
                           sampler=sampler, constellation=Predef[const])
                      | (fields or {})))
    return multi_rx.MultiDvbsReceiver(cfg, NCHAN, chunk_samples=CHUNK_SAMPLES,
                                      device=dev, **seg)


def fleet_frames(dev, gen, code_rate, const="QPSK", esn0_db=12.0, interp=2,
                 nchunks=SEG_CHUNKS):
    """`nchunks` chunks of fleet_stimulus at `code_rate`, scaled by the
    float_scale (the device path's contract); the S=1 runs read the first
    NCHUNKS of them."""
    ra = fleet_rx(dev, code_rate, const=const).readahead
    t0 = time.perf_counter()
    frames = fleet_stimulus(dev, gen, nchunks * CHUNK_SAMPLES + ra,
                            code_rate, const, esn0_db, interp) * 75.0
    torch.cuda.synchronize()
    print(f"[{const} rate {code_rate}] stimulus: {NCHAN} x {frames.shape[1]}"
          f" samples in {time.perf_counter() - t0:.1f} s")
    return frames


def fleet_run(rx, frames, nchunks, tag, steady_from, capture=None,
              gate=True):
    """`nchunks` chunks through rx.process() with every kernel's launch
    count zeroed just before and read just after; per-stage CUDA events
    (host clocks for the host stages, the preprocessing's too); the lock
    and TS gate (gate=False: printed, not a gate). Steady state is chunks
    steady_from.. . capture(k) -> True records the inputs of chunk k's
    demod launches. A receiver with preprocessing reads its chunks from
    the host without the readahead overlap (its host path keeps its own
    backlog). Returns dict(launches, stages, rate in Msamples/s,
    chunk_ms, captured, locked, worst)."""
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.fec import deconv_device as dd
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

    def recorded(demod):
        def wrapper(*a, **kw):
            if capture is not None and capture(chunk[0]):
                captured.append([_clone(v) for v in a])
            return demod(*a, **kw)
        return wrapper

    counted = Launches()
    patches = [(mf_prefilter, "mf_prefilter", timed("mf", mf_prefilter.
                                                   mf_prefilter)),
               (rk, "demod", timed(demod_stage, recorded(rk.demod))),
               (receiver, "run_chunks", timed(demod_stage, recorded(
                   receiver.run_chunks))),
               (multi_rx, "_demod_segmented", timed(
                   "segmented", multi_rx._demod_segmented)),
               (multi_rx, "deconv_append", timed("append",
                                                 multi_rx.deconv_append)),
               (vd, "viterbi_decode", timed("decode", vd.viterbi_decode)),
               (vd, "viterbi_decode_banked", timed(
                   "decode", vd.viterbi_decode_banked)),
               (dd, "deconv_decode", timed("decode", dd.deconv_decode)),
               (multi_rx, "_pack_fetch", timed("pack", multi_rx._pack_fetch)),
               (multi_rx, "_to_host", hosttimed("fetch", multi_rx._to_host,
                                                sync=True)),
               (rx.backend, "feed", hosttimed("backend", rx.backend.feed))]
    pre = [k for k in ("notch", "cnr_est", "spectrum")
           if getattr(rx, k) is not None]
    patches += [(getattr(rx, k), "process",
                 hosttimed(k, getattr(rx, k).process, sync=True))
                for k in pre]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)

    ra = 0 if pre else rx.readahead
    pkts = [[] for _ in range(NCHAN)]
    wall = []
    counted.zero()
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
        launches = counted.read()
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    torch.cuda.synchronize()

    # The decoder's kernel: the ACS of the Viterbi kinds; the hard
    # decode has none (torch ops).
    acs_key = {"viterbi": "acs", "viterbi_banked": "acs_banked"}.get(
        rx.deconv.kind)
    print(f"[{tag}] {nchunks} chunks of {NCHAN} x {CHUNK_SAMPLES}; launches "
          f"{launches}; TRACK={getattr(rx.deconv, 'track', None)}")
    dem_key = "demod" if rx.use_pallas else "scan_demod"
    if launches[dem_key] < nchunks or (acs_key and launches[acs_key] < 1):
        fail(f"{tag} did not run through the kernels: {launches}")
    locks = rx.locks
    if not all(locks) and gate:
        fail(f"{tag}: channels not locked: "
             f"{[c for c, l in enumerate(locks) if not l]}")
    worst = 1.0
    total_good = 0
    for c in range(NCHAN):
        n_after, n_good, span = check_packets(c, pkts[c])
        frac_ok = n_good / max(n_after, 1)
        frac_span = n_good / span
        worst = min(worst, frac_ok, frac_span)
        total_good += int(n_good)
        if gate and (n_good < 100 or frac_ok < 0.9 or frac_span < 0.9):
            fail(f"{tag} channel {c}: {n_good} sent packets decoded of "
                 f"{n_after} after lock, span {span}")
    print(f"[{tag}] TS: {total_good} sent packets decoded over {NCHAN} "
          f"channels; worst channel fraction {worst:.4f}; "
          f"{sum(locks)} of {NCHAN} locked"
          + ("" if gate else " (not a gate on this path)"))

    nsteady = nchunks - steady_from
    stages = dict.fromkeys(tuple(pre) + (
        ("mf", "demod", "append", "decode", "fetch", "backend") if S == 1
        else ("mf", "pass1", "pass2", "splice", "segmented", "append",
              "decode", "fetch", "backend")), 0.0)
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
                chunk_ms=chunk_s * 1e3, captured=captured,
                locked=int(sum(locks)), packets_good=int(total_good),
                worst=float(worst))


def main_path(dev, gen, frames, code_rate="1/2", const="QPSK"):
    """The fleet at `code_rate`, segments=1: NCHUNKS chunks through
    process(); at QPSK rate 1/2 also the pipelined submit() path."""
    rx = fleet_rx(dev, code_rate, const=const)
    tag = f"rate {code_rate}" if const == "QPSK" else f"{const} {code_rate}"
    run = fleet_run(rx, frames, NCHUNKS, tag, 1)
    if code_rate != "1/2" or const != "QPSK":
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


# Slice 8's fleet paths (64 carriers, chunk 2^18, S=1, steady state from
# the second chunk): (name, code rate, constellation, Es/N0 dB, samples
# per symbol, RxConfig fields, chunks, gate). 8PSK 2/3 runs as the 4/6
# trellis (leansdr_tpu/pipelines/multi_rx.py:740), 32 replicas per
# carrier, 2048 ACQUIRE lanes; only part of its carriers lock, in the JAX
# fleet as in the port (ROADMAP queue 3), so its gate is the run through
# the kernels (and the kernels' checks at its shapes), its locks and
# packets printed; BPSK 1/2 on the banked ACS's B=1 instance;
# the preprocessing cell is QPSK 1/2 with anf=1, cnr and want_spectrum,
# at 1 Msps and 250 ksym/s per carrier (a QO-100 DATV rate): the CNR's
# band model needs Fs >= 4 Fm and gives one value per Fs samples, so the
# main path's 4 Msps / 2 Msym/s cannot take it (the JAX fleet refuses it
# too), and 8 chunks of 2^18 give two values and two spectrum lines.
FLEET_PATHS_8 = (
    ("fleet 8PSK 2/3", "2/3", "PSK8", 20.0, 2, {}, NCHUNKS, False),
    ("fleet BPSK 1/2", "1/2", "BPSK", 10.0, 2, {}, NCHUNKS, True),
    ("fleet preproc", "1/2", "QPSK", 12.0, 4,
     dict(Fs=1e6, Fm=250e3, anf=1, cnr=True, want_spectrum=True,
          float_scale=1.0), SEG_CHUNKS, True),
)


def fleet8_path(dev, gen, name, code_rate, const, esn0_db, interp, fields,
                nchunks, gate):
    """One of FLEET_PATHS_8 through fleet_run (its own zeroed counters,
    stage times, the lock and TS gate where `gate`). The preprocessing
    cell reads its
    chunks from the host (float_scale 1: the frames carry the scale) and
    must put out one CNR vector and one spectrum line of each carrier per
    Fs samples, finite; its notch, CNR and spectrum ms per chunk are
    fleet_run's host stages."""
    frames = fleet_frames(dev, gen, code_rate, const, esn0_db, interp,
                          nchunks)
    rx = fleet_rx(dev, code_rate, const=const, fields=fields)
    if const == "PSK8":
        assert rx.rate == "4/6" and rx.deconv.plan.n_lanes == 32 * NCHAN
    run = fleet_run(rx, frames, nchunks, name, 1, gate=gate)
    del frames
    run.pop("captured")
    run.update(const=const, code_rate=code_rate, trellis_rate=rx.rate,
               esn0_db=esn0_db, nsyncs=rx.deconv.plan.nsyncs,
               fs=rx.cfg.Fs, fm=rx.cfg.Fm, gated=gate)
    if rx.cnr_est is not None:
        want = nchunks * CHUNK_SAMPLES // int(rx.cfg.Fs)
        cnr = np.array(rx.cnr)                        # [values, C]
        print(f"[{name}] CNR: {cnr.shape[0]} vectors of {NCHAN} (dB, min "
              f"{cnr.min():.2f}, mean {cnr.mean():.2f}, max "
              f"{cnr.max():.2f}); {len(rx.spectrum_lines)} spectrum lines "
              f"of {NCHAN} x 1024; notch slots "
              f"{sorted(set(rx.notch.slot_i[:, 0].tolist()))[:8]}")
        if (cnr.shape != (want, NCHAN) or not np.isfinite(cnr).all()
                or len(rx.spectrum_lines) != want
                or not all(np.isfinite(l).all() for l in rx.spectrum_lines)):
            fail(f"{name}: {cnr.shape} CNR values, "
                 f"{len(rx.spectrum_lines)} spectrum lines (want {want})")
        run.update(cnr_db_mean=float(cnr.mean()), cnr_vectors=cnr.shape[0],
                   spectrum_lines=len(rx.spectrum_lines))
    return run


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


def hard_path(dev, frames, code_rate, S=1, sampler="rrc"):
    """The hard-decision fleet (viterbi=False, fastlock; the fleet_rx
    configuration otherwise) at `code_rate`: S=1 over NCHUNKS chunks,
    S>1 over SEG_CHUNKS as segmented_path runs it. Its own zeroed
    counters, stage times and gate (fleet_run); the demod launches of
    its first chunk and of one mid-stream chunk (both passes when
    segmented) against demod_ref bit for bit on their first
    SC_DEMOD_CHECK samples. Returns fleet_run's dict with `checked`:
    [(lanes, plain ms)]."""
    tag = f"hard {code_rate}" + (f" S={S}" if S > 1 else "") + (
        f" {sampler}" if sampler != "rrc" else "")
    if S > 1:
        rx = fleet_rx(dev, code_rate, viterbi=False, sampler=sampler,
                      segments=S, seg_holdoff=SEG_HOLDOFF)
        nchunks, steady, mid = SEG_CHUNKS, SEG_HOLDOFF + 1, SEG_CHUNKS - 3
    else:
        rx = fleet_rx(dev, code_rate, viterbi=False, sampler=sampler)
        nchunks, steady, mid = NCHUNKS, 1, NCHUNKS // 2
    run = fleet_run(rx, frames, nchunks, tag, steady, lambda k: k in (0, mid))
    run["checked"] = seg_plain_checks(run.pop("captured"), rx.params,
                                      rx._sym_consts)
    # One decode on the final ring, alone: its device time (CUDA events)
    # and the memory it allocates above what is live before it.
    from leansdr_tpu_torch.fec import deconv_device as dd
    plan, st = rx.deconv.plan, rx.deconv.state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dd.deconv_decode(plan, st)
    torch.cuda.synchronize()
    run["decode_peak_mb"] = (torch.cuda.max_memory_allocated(dev)
                             - base) / 2**20
    run["decode_ms"] = cuda_time(lambda: dd.deconv_decode(plan, st), reps=5)
    print(f"[{tag}] one decode alone: {run['decode_ms']:.3f} ms, "
          f"{run['decode_peak_mb']:.1f} MB allocated at its peak "
          f"(P_call {plan.P_call}, needed {plan.needed} symbols)")
    print(f"[{tag}] demod launches of chunks 0 and {mid} == demod_ref on "
          f"{SC_DEMOD_CHECK} samples: " + "; ".join(
              f"{c} lanes (plain {ms:.0f} ms)" for c, ms in run["checked"]))
    return run


# The fleet CLI's child: `python -c CLI_WRAPPER OUT CAPTURE ARGS...` runs
# leansdr_tpu_torch.apps.leandvbfleet as __main__ with ARGS, counting
# each kernel wrapper's launches, keeping the inputs of the demod calls
# numbered in CAPTURE (their first SC_DEMOD_CHECK + 1 samples), the time
# each submit() returns, the decoder's next_sync calls and the host
# seconds spent in the --acq derotation, dispatch() (host copies, the
# device enqueue) and collect() (the fetch and the byte backend, on the
# backend thread); at exit it writes them to OUT.json and OUT.pt.
CLI_WRAPPER = """
import atexit, json, runpy, sys, time
import torch
from chip_smoke import SC_DEMOD_CHECK, Launches
from leansdr_tpu_torch.dsp import blocks, receiver_kernel as rk
from leansdr_tpu_torch.fec import deconv_device as dd
from leansdr_tpu_torch.pipelines import multi_rx
out, keep = sys.argv[1], {int(v) for v in sys.argv[2].split(",")}
counted = Launches()
calls, captured, marks, resyncs = [0], {}, [], [0]
host = dict(derotate=0.0, dispatch=0.0, collect=0.0)
def hosttimed(cls, name, key):
    fn = getattr(cls, name)
    def wrapper(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            host[key] += time.perf_counter() - t
    setattr(cls, name, wrapper)
hosttimed(blocks.Rotator, "process", "derotate")
hosttimed(multi_rx.MultiDvbsReceiver, "dispatch", "dispatch")
hosttimed(multi_rx.MultiDvbsReceiver, "collect", "collect")
demod, submit, next_sync = (rk.demod, multi_rx.MultiDvbsReceiver.submit,
                            dd.DeviceDeconvolver.next_sync)
def recorded(params, sym_consts, planes, x):
    if calls[0] in keep:
        captured[calls[0]] = dict(
            params=params, sym_consts=sym_consts, planes=planes.clone(),
            x=x[:, :SC_DEMOD_CHECK + 1].clone())
    calls[0] += 1
    return demod(params, sym_consts, planes, x)
def timed(self, iq):
    done = submit(self, iq)
    marks.append(time.perf_counter())
    return done
def counted_sync(self, channel):
    resyncs[0] += 1
    next_sync(self, channel)
rk.demod = recorded
multi_rx.MultiDvbsReceiver.submit = timed
dd.DeviceDeconvolver.next_sync = counted_sync
t0 = time.perf_counter()
def dump():
    torch.save(captured, out + ".pt")
    with open(out + ".json", "w") as f:
        json.dump(dict(launches=counted.read(),
                       marks=[m - t0 for m in marks], resyncs=resyncs[0],
                       host_s=host, main_s=time.perf_counter() - t0), f)
atexit.register(dump)
sys.argv = ["leandvbfleet"] + sys.argv[3:]
runpy.run_module("leansdr_tpu_torch.apps.leandvbfleet", run_name="__main__")
"""


def cli_path(dev, frames):
    """`python -m leansdr_tpu_torch.apps.leandvbfleet` in a child process
    (through CLI_WRAPPER) on the first CLI_CHUNKS chunks of the rate-1/2
    stimulus, float_scale undone, the odd carriers turned a quadrant,
    as interleaved f32 on stdin: 64 carriers, --cr 1/2 --sampler rrc
    --acq --chunk CHUNK_SAMPLES, hard decisions without --fastlock (the
    framer's resyncs must reach the decoder's next_sync), --fd-info on
    stderr. Its tagged multiplex is
    parsed and gated per channel (locked, >= 90% of the packets after
    lock sent ones and of the span sent out, >= CLI_MIN_PACKETS); the
    child's demod and fft4096 must have launched, and its kept demod
    inputs go through the kernel and demod_ref here, equal bit for bit.
    Returns the run's record."""
    import struct
    import tempfile
    n = CLI_CHUNKS * CHUNK_SAMPLES
    x = frames[:, :n] / 75.0
    # Odd carriers a quadrant on (times j): their hard decisions need
    # the framer's resync (next_sync), whichever quadrant the even
    # carriers' loops lock in.
    x[1::2] = torch.stack([-x[1::2, :, 1], x[1::2, :, 0]], dim=-1)
    x = x.transpose(0, 1).contiguous().cpu().numpy()
    args = ["--nchan", str(NCHAN), "--f32", "--float-scale", "75", "-f",
            "4e6", "--sr", "2e6", "--cr", "1/2", "--sampler", "rrc", "--acq",
            "--chunk", str(CHUNK_SAMPLES), "--fd-info", "2"]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "cli")
        cmd = [sys.executable, "-c", CLI_WRAPPER, out,
               ",".join(map(str, CLI_CAPTURE))] + args
        t = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        CHILDREN.append(proc)
        mux, err = proc.communicate(x.tobytes(), timeout=600)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"leandvbfleet exited {proc.returncode}:\n"
                 + err.decode(errors="replace")[-3000:])
        rec = json.loads(Path(out + ".json").read_text())
        captured = torch.load(out + ".pt", map_location=dev,
                              weights_only=False)
    del x
    launches = rec["launches"]
    if launches["demod"] < CLI_CHUNKS or launches["fft4096"] < 1:
        fail(f"leandvbfleet did not run through the kernels: {launches}")
    if rec["resyncs"] < 1:
        fail("leandvbfleet: the framer's resyncs never reached the decoder")
    pkts = [[] for _ in range(NCHAN)]
    o = 0
    while o < len(mux):
        c, k = struct.unpack_from("<II", mux, o)
        o += 8
        if c >= NCHAN or k == 0 or o + 188 * k > len(mux):
            fail(f"leandvbfleet multiplex: bad header ({c}, {k}) at {o - 8}")
        pkts[c] += list(np.frombuffer(mux[o:o + 188 * k], np.uint8)
                        .reshape(k, 188))
        o += 188 * k
    worst, total_good = 1.0, 0
    for c in range(NCHAN):
        n_after, n_good, span = check_packets(c, pkts[c])
        worst = min(worst, n_good / max(n_after, 1), n_good / span)
        total_good += int(n_good)
        if (n_good < CLI_MIN_PACKETS or n_good < 0.9 * n_after
                or n_good < 0.9 * span):
            fail(f"leandvbfleet channel {c}: {n_good} sent packets decoded "
                 f"of {n_after} after lock, span {span}")
    info = [ln for ln in err.decode(errors="replace").splitlines()
            if ln.startswith("FLEET")]
    checked = seg_plain_checks(
        [(a["params"], a["sym_consts"], a["planes"], a["x"])
         for _, a in sorted(captured.items())],
        captured[CLI_CAPTURE[0]]["params"],
        captured[CLI_CAPTURE[0]]["sym_consts"])
    marks = rec["marks"]
    steady = np.diff(marks[1:])               # chunks 2.. (after --acq)
    chunk_s = float(np.mean(steady))
    signal_s = CHUNK_SAMPLES / 4e6
    res = dict(launches=launches, wall_s=wall, main_s=rec["main_s"],
               signal_s=CLI_CHUNKS * signal_s,
               x_real_time_wall=CLI_CHUNKS * signal_s / wall,
               x_real_time_main=CLI_CHUNKS * signal_s / rec["main_s"],
               steady_chunk_ms=chunk_s * 1e3,
               x_real_time_steady=signal_s / chunk_s,
               chunk_ms=[float(v) * 1e3 for v in np.diff([0.0] + marks)],
               resyncs=rec["resyncs"], good_packets=int(total_good),
               host_s=rec["host_s"],
               worst_fraction=worst, info_tail=info[-3:],
               checked=checked)
    print(f"[leandvbfleet] {NCHAN} carriers x {CLI_CHUNKS} chunks "
          f"({res['signal_s']:.3f} s of signal): exit 0, wall {wall:.1f} s "
          f"({res['x_real_time_wall']:.3f}x real time; main() "
          f"{rec['main_s']:.1f} s, {res['x_real_time_main']:.3f}x); steady "
          f"chunks 2..{CLI_CHUNKS - 1}: {chunk_s * 1e3:.1f} ms per chunk, "
          f"{res['x_real_time_steady']:.3f}x real time; launches "
          f"{launches}; next_sync calls {rec['resyncs']}; {total_good} "
          f"sent packets decoded, worst channel fraction {worst:.4f}; "
          f"{info[-3:]}; host seconds over the run: " + ", ".join(
              f"{k} {v:.3f}" for k, v in rec["host_s"].items()))
    print("[leandvbfleet] demod launches "
          f"{', '.join(map(str, CLI_CAPTURE))} == demod_ref on "
          f"{SC_DEMOD_CHECK} samples: " + "; ".join(
              f"{c} lanes (plain {ms:.0f} ms)" for c, ms in checked))
    return res


# The kernels line's name for scan_demod's per-channel-omega mode, counted
# on its own (the counter launch.scan_demod.per_channel).
SCAN_PC = "scan_demod per-channel omega"
# scan_demod's launches on the rrc device-memory instance.
DEVICE_TAPS = "launch.scan_demod.device_taps"
# The kernels line's name for the demod's launches on its phase-error
# table (also counted as demod launches), and their counter.
DEMOD_PE = "demod.pe_table"
DEMOD_PE_COUNTER = "launch.demod.pe_table"

# Every kernel of the port by its name in the kernels line, the demod's
# launches on its phase-error table (DEMOD_PE) and scan_demod's
# per-channel-omega mode (SCAN_PC; their launches are also the demod's
# and scan_demod's), with the port's launch counter of each.
KERNEL_COUNTERS = {"demod": "launch.demod", DEMOD_PE: DEMOD_PE_COUNTER,
                   "acs": "launch.acs",
                   "acs_banked": "launch.acs_banked", "cfir": "launch.cfir",
                   "fir": "launch.fir", "fft4096": "launch.fft4096",
                   "scan_demod": "launch.scan_demod",
                   SCAN_PC: "launch.scan_demod.per_channel",
                   "hs_demod": "launch.hs_demod"}


class Launches:
    """The port's kernel launches by their name in the kernels line,
    counted from the last zero() (the port's `launch.<kernel>`
    counters)."""

    def __init__(self):
        self.zero()

    def zero(self):
        self.base = trace.counters()

    def read(self) -> dict:
        now = trace.counters()
        return {k: now.get(c, 0) - self.base.get(c, 0)
                for k, c in KERNEL_COUNTERS.items()}

    def __iter__(self):
        return iter(KERNEL_COUNTERS)


def _clone(v):
    """A captured launch argument: tensors (and dicts of them) copied."""
    if torch.is_tensor(v):
        return v.clone()
    if isinstance(v, dict):
        return {k: _clone(w) for k, w in v.items()}
    return v


def _flat(v) -> list:
    """The tensors of a kernel's output, in a fixed order: a tensor, or
    tuples and dicts of them."""
    if torch.is_tensor(v):
        return [v]
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _flat(v[k])]
    return [t for w in v for t in _flat(w)]


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
    # The canonical bytes through the scan demod (slice 6): --exact-lut
    # (the trig16 table and the 256x256 LUT, linear sampler), --exact-lut
    # --sampler rrc (the polyphase fir_sampler, 497 taps in steps of
    # 53), --hard-metric (the LUT's cost hardened), --sampler nearest
    # (computed decisions) and --hs (the integer receiver; the CLI sets
    # --anf 0 with it).
    ("exact", dict(Fs=2.4e6, Fm=2e6, rate="1/2", exact_lut=True), "u8",
     2 ** 23 / 2.4e6, (6, 10, True), 20e3, 20.0, 150e3),
    ("exact rrc", dict(Fs=2.4e6, Fm=2e6, rate="1/2", exact_lut=True,
                       sampler="rrc"), "u8",
     2 ** 23 / 2.4e6, (6, 10, True), 20e3, 20.0, 150e3),
    ("hard-metric", dict(Fs=2.4e6, Fm=2e6, rate="1/2", hard_metric=True),
     "u8", 2 ** 23 / 2.4e6, (6, 10, True), 20e3, 20.0, 150e3),
    # --sampler nearest takes the sample nearest the symbol's timing:
    # at the canonical 1.2 samples per symbol that is up to 0.4 symbol
    # off, and neither receiver decodes (the port on the card, the JAX
    # one on the CPU: MER ~8 dB, ROADMAP queue 3), so it runs at 4
    # samples per symbol, 8 Msps u8 (a HackRF or PlutoSDR rate).
    ("nearest", dict(Fs=8e6, Fm=2e6, rate="1/2", sampler="nearest"), "u8",
     1.0, (6, 3, True), 20e3, 20.0, None),
    ("hs", dict(Fs=2.4e6, Fm=2e6, rate="1/2", hs=True, anf=0), "u8",
     2 ** 23 / 2.4e6, (6, 10, True), 20e3, 20.0, 150e3),
)
# Slice 8's single-carrier paths, leandvb --viterbi --fastlock --anf 0 at
# 4 Msps f32 (--float-scale 75), 2 Msym/s, 1 s each, at constellations
# other than QPSK (the `constellation` field names a Predef): DVB-DSNG's
# 8PSK 2/3 (the 2/3 trellis on the banked ACS's B=2 instance, 16
# replicas), BPSK 1/2 (csrc/acs.cu at 2 lanes), 32APSK 4/5 (the 4/5
# tables; behind the matched filter, --sampler rrc: its three rings do
# not survive the unmatched pulse's intersymbol interference on the
# linear sampler) and 16APSK 3/4, each at an Es/N0 (dB) it locks at; then
# --cnr --fd-spectrum on a u8 stream at 4.8 Msps of a 1.2 Msym/s carrier
# (the CNR's band model needs Fs >= 4 Fm, so the canonical 2.4 Msps
# stream cannot take it: the JAX receiver and the reference refuse it
# too), 2.5 s: two CNR values and two spectrum lines, one per Fs
# samples. The last field is `twin` (single_carrier): the 4/5 code is
# transparent to 32APSK's 180-degree rotation (ROADMAP queue 3), so when
# the carrier loop settles on a half-turn from the sent phase the
# election keeps the rotation's lower-indexed twin, in the JAX receiver
# as in the port (tests/test_torch_apsk32_twin.py), and the stream does
# not lock; the path then passes only if the twin's discriminant tied
# the elected sync's in every chunk and a replay with the twin pinned
# locks and decodes the packets.
SC_PATHS_8 = (
    ("psk8_23", dict(Fs=4e6, Fm=2e6, constellation="PSK8", rate="2/3",
                     fastlock=True, viterbi=True, anf=0, float_scale=75.0),
     "f32", 1.0, (3, 3, True), 20e3, 20.0, None, False),
    ("bpsk_12", dict(Fs=4e6, Fm=2e6, constellation="BPSK", rate="1/2",
                     fastlock=True, viterbi=True, anf=0, float_scale=75.0),
     "f32", 1.0, (3, 3, True), 20e3, 12.0, None, False),
    ("apsk32_45", dict(Fs=4e6, Fm=2e6, constellation="APSK32", rate="4/5",
                       fastlock=True, viterbi=True, anf=0, sampler="rrc",
                       float_scale=75.0),
     "f32", 1.0, (3, 3, True), 20e3, 24.0, None, True),
    ("apsk16_34", dict(Fs=4e6, Fm=2e6, constellation="APSK16", rate="3/4",
                       fastlock=True, viterbi=True, anf=0,
                       float_scale=75.0),
     "f32", 1.0, (3, 3, True), 20e3, 24.0, None, False),
    ("cnr", dict(Fs=4.8e6, Fm=1.2e6, rate="1/2", anf=0, cnr=True,
                 want_spectrum=True), "u8", 2.5, (4, 2, True), 20e3, 20.0,
     None, False),
)


def sc_stimulus(const, rate, fs, seconds, updown, f_off, esn0_db, birdie,
                fmt, rng):
    """Wire bytes of `seconds` of one DVB-S carrier of constellation
    `const` (a Predef name) at rate `rate`: the
    port's modulation of numbered TS packets resampled from 2 samples per
    symbol to fs (see SC_PATHS for `pick`), shifted by f_off Hz, with
    AWGN at Es/N0, an optional CW birdie 20 dB below the carrier's power
    (16 dB above the carrier in its 4096-point FFT bin), quantized to fmt
    (u8 ~ 30 LSB rms, s16 ~ 3000 LSB rms, f32 unit rms for
    --float-scale 75). Returns (bytes, packets sent)."""
    from scipy.signal import resample_poly
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec.convenc import FEC_SPECS
    from leansdr_tpu_torch.fec.viterbi_banked import viterbi_rate
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    up, down, pick = updown
    n = int(round(seconds * fs))
    cst = make_dvbs2_constellation(Predef[const], rate)
    bits_in, bits_out = FEC_SPECS[viterbi_rate(rate, cst.nsymbols)]
    nsym = n * down / (2 * up)
    npkt = int(nsym * cst.bits_per_symbol * bits_in / bits_out / 1632) + 16
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(constellation=Predef[const],
                                           rate=rate, interp=2))
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
    from leansdr_tpu_torch.dsp import receiver, receiver_hs
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    pairs = {"demod": (rk.demod, rk.demod_ref),
             "acs": (vd.viterbi_acs, vd.viterbi_acs_ref),
             "acs_banked": (vb.viterbi_acs_banked, vb.viterbi_acs_banked_ref),
             "cfir": (fk.cfir, fk.cfir_ref),
             "scan_demod": (receiver.run_chunks, receiver.run_chunks_ref),
             "hs_demod": (receiver_hs.run_chunks_hs,
                          receiver_hs.run_chunks_hs_ref)}
    done = []
    for key, calls in inputs.items():
        kern, ref = pairs[key]
        for n, a, kw in calls:
            if key in ("demod", "hs_demod"):
                a = a[:3] + [a[3][:, :SC_DEMOD_CHECK + 1].contiguous()]
            elif key == "scan_demod":
                a = a[:3] + [a[3][:, :SC_DEMOD_CHECK
                                  + a[0].readahead].contiguous()]
            k = kern(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = ref(*a, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            k, r = _flat(k), _flat(r)
            for i, (u, w) in enumerate(zip(k, r)):
                if not torch.equal(u, w):
                    fail(f"{name}: {key} launch {n}: output {i} differs from "
                         f"the plain version in {int((u != w).sum())} "
                         "entries")
            shape = " ".join(f"{list(v.shape)}" for v in a[3:]
                             if torch.is_tensor(v)) if key.endswith(
                "demod") else " ".join(f"{list(v.shape)}" for v in a
                                       if torch.is_tensor(v))
            done.append((key, n, shape, plain_ms))
    print(f"[{name}] kernels == plain versions on the path's inputs: "
          + "; ".join(f"{k} launch {n} {sh} (plain {ms:.0f} ms)"
                      for k, n, sh, ms in done))
    return done


def single_carrier(dev, rng, stimuli, name, fields, fmt, seconds, updown,
                   f_off, esn0_db, birdie, stimulus=None, twin=False):
    """One single-carrier path: the wire stream through DvbsReceiver in
    leandvb's 2^17-sample reads (read_iq -> process), with every kernel's
    launch count zeroed just before and read just after, device stages
    timed with CUDA events and host stages with the host clock; then the
    inputs of chosen launches against the plain versions
    (sc_plain_checks). Paths with the same stimulus parameters read the
    same bytes (`stimuli` keeps them); `stimulus` = (bytes, frames sent)
    gives an --hdlc path its own, gated on its frames (check_frames).
    twin=True (32APSK 4/5, SC_PATHS_8): a stream that fails the gate
    passes if it failed by electing the 180-degree twin of the sync it
    was sent under, as the reference's election does (twin_replay)."""
    from leansdr_tpu_torch.dsp import fir_kernel as fk
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver, receiver_hs
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec import viterbi_device as vd
    from leansdr_tpu_torch.pipelines import dvbs_rx, multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_tpu_torch.util.iofmt import read_iq

    from leansdr_tpu_torch.dsp.cstln import Predef

    # leandvb's defaults, then the stream's flags.
    const = fields.get("constellation", "QPSK")
    cfg = RxConfig(**(dict(anf=1, exact_lut=False) | fields
                      | dict(constellation=Predef[const])))
    t0 = time.perf_counter()
    key = (const, cfg.rate, cfg.Fs, seconds, updown, f_off, esn0_db, birdie,
           fmt)
    if stimulus is not None:
        raw, sent = stimulus
        npkt = len(sent)
    else:
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
                    (n, [_clone(v) for v in a], kw))
            return fn(*a, **kw)
        return wrapper

    kernels = {"demod": (rk, "demod"), "acs": (vd, "viterbi_acs"),
               "acs_banked": (vb, "viterbi_acs_banked"),
               "cfir": (fk, "cfir"), "scan_demod": (receiver, "run_chunks"),
               "hs_demod": (receiver_hs, "run_chunks_hs")}
    # The wrappers (their counters) before the timing patches.
    counted = Launches()
    patches = [(mf_prefilter, "mf_prefilter",
                timed("mf", mf_prefilter.mf_prefilter)),
               (multi_rx, "_demod_segmented",
                timed("segmented", multi_rx._demod_segmented))]
    patches += [(m, a, timed(k, captured(k, getattr(m, a))))
                for k, (m, a) in kernels.items()]
    ftaps = []                       # the carrier tap of each CNR call

    def tapped(fn):
        def wrapper(z, freq_tap=0.0):
            ftaps.append(freq_tap)
            return fn(z, freq_tap)
        return wrapper

    for attr in ("notch", "cnr_est", "spectrum", "resampler", "deconv",
                 "hdlc_sync"):
        blk = getattr(rx, attr, None)
        if blk is not None:
            fn = tapped(blk.process) if attr == "cnr_est" else blk.process
            patches.append((blk, "process", hosttimed(attr, fn)))
    if cfg.awgn:
        patches.append((dvbs_rx.chansim, "wgn_c",
                        hosttimed("wgn_c", dvbs_rx.chansim.wgn_c)))
    if cfg.hdlc:
        patches.append((dvbs_rx, "etr192_descramble",
                        hosttimed("etr192", dvbs_rx.etr192_descramble)))
    patches.append((rx, "_byte_stages", hosttimed("bytes", rx._byte_stages)))
    discr = []                       # each chunk's (elected, discriminants)
    if twin:
        advance = rx.deconv._advance

        def electing(us, totaldiscr, election):
            out = advance(us, totaldiscr, election)
            discr.append((rx.deconv.current, totaldiscr.copy()))
            return out
        patches.append((rx.deconv, "_advance", electing))
    saved = [(obj, a, getattr(obj, a)) for obj, a, _ in patches]
    for obj, a, fn in patches:
        setattr(obj, a, fn)
    itemsize = {"u8": 2, "s16": 4, "f32": 8}[fmt]
    step = (1 << 17) * itemsize
    ts = []
    counted.zero()
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
        launches = counted.read()
        for obj, a, fn in saved:
            setattr(obj, a, fn)
    device = {}
    for key, s, e in events:
        device[key] = device.get(key, 0.0) + s.elapsed_time(e)
    if cfg.hdlc:
        n_after, n_good, span = check_frames(rx.hdlc_frames.tobytes(), sent)
        lock, unit = rx.hdlc_sync.lock_state, "frames"
    else:
        pkts = np.concatenate(ts) if ts else np.empty((0, 188), np.uint8)
        n_after, n_good, span = check_packets(0, list(pkts))
        lock, unit = rx.lock, "packets"
    demod_key = ("hs_demod" if cfg.hs else "demod" if rx.use_pallas
                 else "scan_demod")
    need = [demod_key] + (["cfir"] if cfg.resample else []) + (
        ["acs" if cfg.rate == "1/2" else "acs_banked"] if cfg.viterbi
        else [])
    slots = None if rx.notch is None else rx.notch.b.slot_i.tolist()
    print(f"[{name}] launches {launches}; lock {lock}, locktime "
          f"{rx.locktime}, VBER {rx.vber:.2e}, notch slots "
          f"{slots}; {n_good} sent {unit} of "
          f"{n_after} after lock (span {span}; {npkt} sent)")
    if any(launches[k] < 1 for k in need):
        fail(f"{name}: the path did not run through {need}: {launches}")
    passed = (lock and n_good >= 100
              and n_good >= 0.9 * max(n_after, span))
    twin_run = (twin_replay(dev, name, cfg, raw, fmt, rx, discr)
                if twin and not passed else None)
    if not passed and twin_run is None:
        fail(f"{name}: {n_good} sent {unit} decoded of {n_after} after "
             f"lock, span {span}, lock {lock}")
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
    estimators = (cnr_replay(name, cfg, rx, raw, fmt, ftaps)
                  if cfg.cnr or cfg.want_spectrum else None)
    return dict(path=name, fmt=fmt, fs=cfg.Fs, samples=nsamp, wall_s=wall,
                constellation=const, rate=cfg.rate, esn0_db=esn0_db,
                lock=bool(lock), twin_replay=twin_run,
                estimators=estimators,
                msamples_per_s=nsamp / wall / 1e6, x_real_time=xrt,
                device_ms=device, host_ms=host, launches=launches,
                packets_good=int(n_good), packets_after_lock=int(n_after),
                unit=unit,
                slots=slots, mer_db=(rx.meas["mer"][-1] if rx.meas["mer"]
                                     else None),
                plain_checks=[dict(kernel=k, launch=n, shapes=sh,
                                   plain_ms=ms) for k, n, sh, ms in checks])


def twin_replay(dev, name, cfg, raw, fmt, rx, discr) -> dict:
    """A 32APSK 4/5 stream that did not lock (single_carrier, twin=True).
    The code turns data XOR 0x66 into code XOR 0b00110 per symbol, which
    is 32APSK's half-turn relabelling, so the sync a half-turn from the
    elected one decodes to the same metrics, and the election (argmax,
    strictly greater switches) keeps the lower index. Fails unless the
    elected sync's discriminant equals its half-turn twin's in every
    chunk, and the same bytes through a fresh receiver with the twin
    pinned (no election) lock with >= 90% of the sent packets after
    lock. Returns the replay's result."""
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver
    from leansdr_tpu_torch.util.iofmt import read_iq
    d = rx.deconv
    e = d.current
    r = e % d.nrot
    t = e - r + (r + d.nrot // 2) % d.nrot
    ties = sum(int(v[e]) == int(v[t]) for _, v in discr)
    print(f"[{name}] twin: elected sync {e}, its half-turn twin {t}; "
          f"discriminants equal in {ties} of {len(discr)} chunks")
    if not discr or ties < len(discr):
        fail(f"{name}: no lock, and not the half-turn tie: sync {e} vs "
             f"{t} equal in {ties} of {len(discr)} chunks")
    rx2 = DvbsReceiver(cfg, device=dev)
    rx2.deconv.current = t
    rx2.deconv.resync_phase, rx2.deconv.resync_period = 1, 1 << 62
    step = (1 << 17) * {"u8": 2, "s16": 4, "f32": 8}[fmt]
    t0 = time.perf_counter()
    ts = [rx2.process(read_iq(raw[o:o + step], fmt))
          for o in range(0, len(raw), step)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_after, n_good, span = check_packets(0, list(np.concatenate(ts)))
    print(f"[{name}] twin {t} pinned: lock {rx2.lock}, locktime "
          f"{rx2.locktime}; {n_good} sent packets of {n_after} after lock "
          f"(span {span}) in {wall:.3f} s")
    if (not rx2.lock or n_good < 100
            or n_good < 0.9 * max(n_after, span)):
        fail(f"{name}: with twin {t} pinned, {n_good} sent packets decoded "
             f"of {n_after} after lock, span {span}, lock {rx2.lock}")
    return dict(elected=e, twin=t, chunks=len(discr), ties=ties,
                lock=bool(rx2.lock), packets_good=int(n_good),
                packets_after_lock=int(n_after), wall_s=wall)


def cnr_replay(name, cfg, rx, raw, fmt, ftaps) -> dict:
    """--cnr and --fd-spectrum of a single-carrier path (their FFT on the
    card) against the port's CPU run of the same estimators (CnrFft1,
    Spectrum1 on device="cpu") on the same reads with the same carrier
    taps: as many CNR values and spectrum lines, one per Fs samples, each
    within 0.01 dB. The path must have no notch or derotator (the
    estimators then read the float-scaled input as it is)."""
    from leansdr_tpu_torch.dsp.blocks_device import CnrFft1, Spectrum1
    from leansdr_tpu_torch.util.iofmt import read_iq
    every = max(int(cfg.Fs), 1)
    cnr = CnrFft1(cfg.Fm / cfg.Fs, decimation=every, device="cpu")
    spec = Spectrum1(decimation=every, device="cpu")
    vals, lines = [], []
    step = (1 << 17) * {"u8": 2, "s16": 4, "f32": 8}[fmt]
    for i, o in enumerate(range(0, len(raw), step)):
        iq = read_iq(raw[o:o + step], fmt) * np.float32(cfg.float_scale)
        z = iq[:, 0] + 1j * iq[:, 1]
        if cfg.cnr:
            vals += cnr.process(z, ftaps[i])
        if cfg.want_spectrum:
            lines += spec.process(z)
    nsamp = len(raw) // {"u8": 2, "s16": 4, "f32": 8}[fmt]
    want = nsamp // int(cfg.Fs)
    got_v, got_l = rx.meas["cnr"], rx.spectrum_lines
    dv = max((abs(a - b) for a, b in zip(got_v, vals)), default=0.0)
    dl = max((float(np.abs(a - b).max()) for a, b in zip(got_l, lines)),
             default=0.0)
    print(f"[{name}] CNR (dB) {[round(v, 3) for v in got_v]}, "
          f"{len(got_l)} spectrum lines of {len(got_l[0]) if got_l else 0} "
          f"bins (one per {int(cfg.Fs)} samples); against the CPU run: max "
          f"|d| {dv:.2e} dB (CNR), {dl:.2e} dB (spectrum)")
    if (len(got_v) != len(vals) or len(got_l) != len(lines)
            or len(got_v) != want * cfg.cnr
            or len(got_l) != want * cfg.want_spectrum
            or dv > 0.01 or dl > 0.01):
        fail(f"{name}: CNR {got_v} / {len(got_l)} spectrum lines on the card"
             f" != the CPU run's {vals} / {len(lines)} (want {want} each, "
             "within 0.01 dB)")
    return dict(cnr_db=got_v, cnr_db_cpu=vals, spectrum_lines=len(got_l),
                max_diff_db_cnr=dv, max_diff_db_spectrum=dl)


# ------------------------------------------- the scan demods (slice 6)

def scan_params(sampler, exact, fs=4e6, **fields):
    """The scan demod's parameters as the receivers build them at sample
    rate fs for 2 Msym/s QPSK (the rrc sampler's polyphase coefficients
    at fs: 499 taps in steps of 32 at 4 Msps, 497 in 53 at 2.4 Msps;
    `fields` are further RxConfig fields, rrc_rej)."""
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig, rrc_sampler
    co, steps = ((), 1)
    if sampler == "rrc":
        co, steps = rrc_sampler(fs, RxConfig(Fs=fs, Fm=2e6, **fields))
    return receiver.ReceiverParams(omega=fs / 2e6, sampler=sampler,
                                   exact_lut=exact, rrc_coeffs=co,
                                   rrc_steps=steps)


def _scan_compare(tag, kern, ref, args):
    """kern(*args) and ref(*args): every output and state plane equal
    (torch.equal), and the kernel left its input state as it was. Returns
    (kernel result, plain ms, max |kernel - plain| over every plane)."""
    before = _flat(_clone(args[2]))
    k = kern(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(before, _flat(args[2]))):
        fail(f"{tag}: the kernel wrote its input state")
    t0 = time.perf_counter()
    r = ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fk, fr = _flat(k), _flat(r)
    bad = [(i, int((u != w).sum())) for i, (u, w) in enumerate(zip(fk, fr))
           if not torch.equal(u, w)]
    if bad or len(fk) != len(fr):
        fail(f"{tag}: kernel != plain version in outputs (index, entries) "
             f"{bad}")
    err = max((float((u.double() - w.double()).abs().max())
               for u, w in zip(fk, fr) if u.numel()), default=0.0)
    return k, plain_ms, err


def check_scan_demod(dev, gen):
    """scan_demod == run_chunks_ref and hs_demod == run_chunks_hs_ref, on
    every output and state plane bit for bit: each sampler (nearest,
    linear, and rrc at each SCAN_RRC geometry: the 16- and 10-tap
    instances, the general shared-memory one, the device-memory one) x
    decision mode (exact LUT, computed) and --hs (omega 2.0 and 1.2), at C
    in SCAN_CHECK_C over SCAN_CHUNKS chunks, from the cold state and again
    from the kernel's end state on the next samples; the rrc launches'
    instance from the wrapper's counter. Also the four sincos entries
    hs_demod takes from the table. Returns (the measured max |kernel -
    plain| over every case and plane, the plain version's ms per case)."""
    from leansdr_tpu_torch.dsp import receiver, receiver_hs
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    tables = receiver.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                                  dev)
    plain, err = {}, 0.0
    cases = [(s, 4e6, {}) for s in ("nearest", "linear")] + list(SCAN_RRC)
    for label, fs, fields in cases:
        for exact in (True, False):
            p = scan_params(label.split()[0], exact, fs, **fields)
            device_taps = (p.sampler == "rrc"
                           and not receiver.taps_in_shared(p, 4))
            if device_taps != ("steps 2048" in label):
                fail(f"scan_demod {label}: taps_in_shared "
                     f"{not device_taps}, smem {receiver.smem_bytes(p, 4)}")
            n = SCAN_CHUNKS * receiver.CHUNK
            for C in SCAN_CHECK_C:
                x = demod_stimulus("QPSK", "1/2", C, 2 * n + p.readahead - 1,
                                   dev, gen)
                st = receiver.init_state(p, C, dev)
                emitted = 0
                d0 = trace.counters().get(DEVICE_TAPS, 0)
                for part in (0, 1):
                    xs = x[:, part * n:(part + 1) * n + p.readahead]
                    (st, out), ms, e = _scan_compare(
                        f"scan_demod {label} exact={exact} C={C}",
                        receiver.run_chunks, receiver.run_chunks_ref,
                        (p, tables, st, xs.contiguous()))
                    err = max(err, e)
                    emitted += int(out["valid"].sum())
                if trace.counters().get(DEVICE_TAPS, 0) - d0 != (
                        2 if device_taps else 0):
                    fail(f"scan_demod {label} C={C}: not the "
                         f"{'device' if device_taps else 'shared'}-memory "
                         "instance")
                plain[(label, exact, C)] = ms
                if emitted < C * n // 2:
                    fail(f"scan_demod {label} exact={exact} C={C}: "
                         f"{emitted} symbols in {2 * n} samples")
    ht = receiver_hs.hs_tables(dev)
    for omega in (2.0, 1.2):
        hp = receiver_hs.HsParams(omega=omega)
        for C in SCAN_CHECK_C:
            n = SCAN_CHUNKS * receiver_hs.CHUNK
            x = demod_stimulus("QPSK", "1/2", C, 2 * n, dev, gen)
            x = torch.clamp(torch.round(x * (40 / 75.0) + 128), 0,
                            255).to(torch.int32)
            st = receiver_hs.init_state(hp, C, dev)
            for part in (0, 1):
                (st, out), ms, e = _scan_compare(
                    f"hs_demod omega={omega} C={C}",
                    receiver_hs.run_chunks_hs, receiver_hs.run_chunks_hs_ref,
                    (hp, ht, st,
                     x[:, part * n:(part + 1) * n + 1].contiguous()))
                err = max(err, e)
            plain[("hs", omega, C)] = ms
    args = receiver_hs._hs_args(receiver_hs.HsParams(omega=2.0))
    want = [(int(ht["sincos_re"][i]), int(ht["sincos_im"][i]))
            for i in receiver_hs.SINCOS_AT]
    if list(zip(args.sc_re, args.sc_im)) != want:
        fail(f"hs_demod's sincos entries {list(zip(args.sc_re, args.sc_im))}"
             f" != the table's {want}")
    print(f"scan_demod == run_chunks_ref and hs_demod == run_chunks_hs_ref "
          f"bit for bit (every output and state plane; 2 x {SCAN_CHUNKS} "
          f"chunks at C in {SCAN_CHECK_C}; samplers nearest, linear, "
          f"{', '.join(r[0] for r in SCAN_RRC)} x exact, computed; hs at "
          f"omega 2.0, 1.2); hs sincos entries at {receiver_hs.SINCOS_AT} "
          f"== table {want}; plain ms per call: " + ", ".join(
              f"{k} {v:.0f}" for k, v in plain.items()))
    return err, plain


def check_scan_8psk(dev, gen) -> dict:
    """scan_demod == run_chunks_ref bit for bit at 8PSK (2/3): the
    linear sampler in both decision modes (the 8PSK LUT; the generic
    nsymbols-way computed decision) at C=64 over SCAN_CHUNKS chunks, cold
    and live. Returns the plain version's ms per mode."""
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    plain = {}
    t8 = receiver.make_tables(make_dvbs2_constellation(Predef.PSK8, "2/3"),
                              dev)
    for exact in (True, False):
        p = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                    exact_lut=exact, nsymbols=8)
        n = SCAN_CHUNKS * receiver.CHUNK
        x = demod_stimulus(Predef.PSK8, "2/3", NCHAN,
                           2 * n + p.readahead - 1, dev, gen)
        st = receiver.init_state(p, NCHAN, dev)
        emitted = 0
        for part in (0, 1):
            (st, out), ms, e = _scan_compare(
                f"scan_demod 8PSK exact={exact} C={NCHAN}",
                receiver.run_chunks, receiver.run_chunks_ref,
                (p, t8, st, x[:, part * n:(part + 1) * n
                                + p.readahead].contiguous()))
            emitted += int(out["valid"].sum())
        plain[f"scan_demod 8PSK exact={exact}"] = ms
        if emitted < NCHAN * n // 2 or int(out["symbol"].max()) < 4:
            fail(f"scan_demod 8PSK exact={exact}: {emitted} symbols, "
                 f"largest {int(out['symbol'].max())}")
    print("scan_demod == run_chunks_ref at 8PSK (linear, exact and "
          f"computed, C={NCHAN}): plain ms " + ", ".join(
              f"{k} {v:.0f}" for k, v in plain.items()))
    return plain


def per_channel_omegas(C: int) -> np.ndarray:
    """The omegas of check_scan_per_channel: the grid's at C=4 (9.6,
    7.2072, 2.4, 1.2), else C distinct ones from 1.2 to 9.6."""
    if C == len(SCAN_SRS):
        return np.array([SCAN_FS / sr for sr in SCAN_SRS], np.float32)
    return np.linspace(1.2, 9.6, C).astype(np.float32)


def check_scan_per_channel(dev, gen) -> tuple:
    """scan_demod's per-channel-omega mode == run_chunks_ref on every
    output and state plane bit for bit: each sampler (nearest, linear,
    rrc at the fleet's geometry) x decision mode (exact LUT, computed)
    at C in SCAN_PC_C with per_channel_omegas(C), over SCAN_CHUNKS chunks
    from the cold state and again from the kernel's end state; each
    channel emits about one symbol in its omega samples. Returns (the
    measured max |kernel - plain| over every case and plane, the plain
    version's ms per case)."""
    import dataclasses
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    tables = receiver.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                                  dev)
    plain, err = {}, 0.0
    for label in ("nearest", "linear", "rrc"):
        for exact in (True, False):
            p = dataclasses.replace(scan_params(label, exact),
                                    omega_per_channel=True)
            n = SCAN_CHUNKS * receiver.CHUNK
            for C in SCAN_PC_C:
                om = per_channel_omegas(C)
                x = demod_stimulus("QPSK", "1/2", C, 2 * n + p.readahead - 1,
                                   dev, gen)
                st = receiver.init_state(p, C, dev)
                st.update(receiver.per_channel_omega_state(p, om, dev))
                emitted = torch.zeros(C, device=dev)
                for part in (0, 1):
                    xs = x[:, part * n:(part + 1) * n + p.readahead]
                    (st, out), ms, e = _scan_compare(
                        f"scan_demod per-channel {label} exact={exact} "
                        f"C={C}", receiver.run_chunks,
                        receiver.run_chunks_ref,
                        (p, tables, st, xs.contiguous()))
                    err = max(err, e)
                    emitted += out["valid"].sum(1)
                plain[(label, exact, C)] = ms
                want = torch.from_numpy(2 * n / om).to(dev)
                if not torch.all((emitted - want).abs() <= 0.2 * want + 2):
                    fail(f"scan_demod per-channel {label} exact={exact} "
                         f"C={C}: {emitted.tolist()} symbols, expected "
                         f"~{want.tolist()}")
    print("scan_demod per-channel omega == run_chunks_ref bit for bit "
          f"(2 x {SCAN_CHUNKS} chunks; C in {SCAN_PC_C}; nearest, linear, "
          "rrc x exact, computed); plain ms per call: " + ", ".join(
              f"{k} {v:.0f}" for k, v in plain.items()))
    return err, plain


def scan_chain(built, lat, clock) -> dict:
    """The scan demods' serial chain per emitted symbol from their built
    libraries' SASS (tools/sass_chain.py --hot-loads: the symbol loop per
    SCAN_FUNCTIONS, the emitting step with its table gathers kept),
    scan_kernel per emitted symbol and hs_kernel per sample. The scan
    kernels' gathers (LDG) are priced twice: at the L1-hit latency of
    tools/latency_probe.cu (`cycles_per_step`) and at its L2-hit latency
    (`cycles_per_step_l2`); hs_kernel's gathers are shared-memory loads
    (LDS)."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    text = sass_of(built["scan_demod"][0])
    lat_l2 = dict(lat, LDG=lat["LDG.L2"])
    out = {}
    for key, fn in SCAN_FUNCTIONS.items():
        r = sass_chain.analyse(text, fn, lat, "STG", "FMNMX", hot_loads=True)
        r["cycles_per_step_l2"] = sass_chain.analyse(
            text, fn, lat_l2, "STG", "FMNMX",
            hot_loads=True)["cycles_per_step"]
        out[key] = r
    out["hs"] = sass_chain.analyse(sass_of(built["hs_demod"][0]),
                                   "hs_kernel", lat, "STS", "F2I")
    out["hs"]["cycles_per_step_l2"] = out["hs"]["cycles_per_step"]
    for k, r in out.items():
        print(f"scan chain [{k}] (tools/sass_chain.py, {r['function'][:48]}"
              f" loop {r['loop'][0]}-{r['loop'][1]}): "
              f"{r['cycles_per_step']:.1f} cycles per step "
              f"({r['cycles_per_step'] / clock * 1e9:.1f} ns; gathers at "
              f"L2 {r['cycles_per_step_l2']:.1f}), "
              f"{r['path_instructions_per_step']:.1f} instructions on the "
              f"path, {r['instructions_per_step']:.1f} per step, issue "
              f"{r['issue_cycles_per_step']:.1f} cycles; mix {r['mix']}; "
              f"priced as fixed-pipe: {', '.join(r['priced_as_fixed'])}")
    return out


def exact_fleet_path(dev, frames, S=1, viterbi=True):
    """The fleet on the scan demod's exact route with the polyphase rrc
    sampler at 4 Msps (exact_lut=True, sampler="rrc"), rate 1/2: S=1 over
    NCHUNKS chunks or S=8 over SEG_CHUNKS, Viterbi or hard decisions; its
    own zeroed counters, stage times and gate (fleet_run); the scan
    launches of its first chunk and of one mid-stream chunk against
    run_chunks_ref bit for bit on their first SCAN_PLAIN samples."""
    from leansdr_tpu_torch.dsp import receiver
    tag = "exact rrc 1/2" + (f" S={S}" if S > 1 else "") + (
        "" if viterbi else " hard")
    seg = dict(segments=S, seg_holdoff=SEG_HOLDOFF) if S > 1 else {}
    rx = fleet_rx(dev, "1/2", viterbi=viterbi, exact=True, **seg)
    if rx.use_pallas or rx.params.readahead != 16:
        fail(f"{tag}: not the scan demod's polyphase route")
    nchunks, steady, mid = ((SEG_CHUNKS, SEG_HOLDOFF + 1, SEG_CHUNKS - 3)
                            if S > 1 else (NCHUNKS, 1, NCHUNKS // 2))
    run = fleet_run(rx, frames, nchunks, tag, steady, lambda k: k in (0, mid))
    checked = []
    for a in run.pop("captured"):
        p, tables, st, x = a
        xs = x[:, :SCAN_PLAIN + p.readahead].contiguous()
        _, ms, _ = _scan_compare(f"{tag} launch", receiver.run_chunks,
                              receiver.run_chunks_ref, (p, tables, st, xs))
        checked.append((x.shape[0], ms))
    run["checked"] = checked
    run["mer_db"] = [float(v) for v in rx.metrics()["mer_db"][:4]]
    print(f"[{tag}] scan launches of chunks 0 and {mid} == run_chunks_ref "
          f"on {SCAN_PLAIN} samples: " + "; ".join(
              f"{c} lanes (plain {ms:.0f} ms)" for c, ms in checked)
          + f"; MER of carriers 0-3 {run['mer_db']}")
    return run


def stimulus_24(frames, n):
    """Carrier 0 of the fleet's 4 Msps stimulus resampled to 2.4 Msps (a
    2 Msym/s carrier at 1.2 samples per symbol, as the canonical stream),
    [1, n, 2] float32 on the stimulus's device."""
    from scipy.signal import resample_poly
    m = int(n / 0.6) + 64
    z = frames[0, :m].double().cpu().numpy()
    y = resample_poly(z[:, 0] + 1j * z[:, 1], 3, 5)[:n]
    return torch.from_numpy(np.stack([y.real, y.imag], -1)[None].astype(
        np.float32)).to(frames.device)


# scan_times' shapes: (key, C, samples, sampler, sample rate, chain key);
# C=512 x (2^15 + 128) is the S=8 fleet's pass-2 launch.
SCAN_TIMED = (("fleet", NCHAN, CHUNK_SAMPLES, "rrc", 4e6, "rrc exact"),
              ("pass2", 512, (1 << 15) + 128, "rrc", 4e6, "rrc exact"),
              ("single", 1, 1 << 17, "linear", 4e6, "linear exact"),
              ("single rrc 2.4", 1, 1 << 17, "rrc", 2.4e6,
               "rrc exact 2.4 Msps"))


def scan_times(dev, frames, chains, clock) -> dict:
    """The scan demods at the main paths' shapes (CUDA events), exact LUT,
    SCAN_TIMED: the fleet launch (C=64, one 2^18-sample chunk, polyphase
    rrc), the S=8 fleet's pass-2 launch (C=512: eight 2^15 + 128-sample
    windows of each carrier), a single carrier's per-read launch (C=1,
    2^17 samples, linear at 4 Msps; rrc at 2.4 Msps on carrier 0
    resampled), and hs_demod's (C=1, 2^17, the stimulus as u8 at 40 LSB,
    at omega 2.0 and, resampled, the --hs stream's 1.2), each from the
    state one launch over the same samples left. Bounds: bytes (input,
    the tables the instance reads (scan_table_bytes) and state read once,
    packed words and per-chunk measurements written once) over 3.35 TB/s,
    or the float operations of its SASS hot path (step_flops) over the
    float32 peak, the larger; the serial chain of scan_chain times
    the symbols this input emits per carrier (hs: per sample) over the
    max SM clock, its gathers priced at L1 and at L2 hits. Beside each,
    the cycles per emitted symbol (hs: per sample) the time gives."""
    from leansdr_tpu_torch.dsp import receiver, receiver_hs
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    tables = receiver.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                                  dev)
    x24 = stimulus_24(frames, (1 << 17) + 64)
    out = {}
    for key, C, n, sampler, fs, chain_key in SCAN_TIMED:
        p = scan_params(sampler, True, fs)
        n1 = n + p.readahead
        if key == "pass2":
            x = torch.cat([frames[:, o:o + n1] for o in range(
                0, 8 << 15, 1 << 15)]).contiguous()
        elif fs == 2.4e6:
            x = x24[:, :n1].contiguous()
        else:
            x = frames[:C, :n1].contiguous()
        st = receiver.init_state(p, C, dev)
        st, o = receiver.run_chunks(p, tables, st, x)   # a locked state
        ms = cuda_time(lambda: receiver.run_chunks(p, tables, st, x), reps=3)
        emitted = int(o["valid"].sum())
        K = n // receiver.CHUNK
        nbytes = (x.numel() * 4 + scan_table_bytes(tables, p) + C * n * 4
                  + C * K * 24 + 2 * C * (21 * 4 + len(p.rrc_coeffs) * 8))
        ch = chains[chain_key]
        per = emitted / C / clock * 1e3
        out[key] = dict(ms=ms, bound=bound_ms(nbytes,
                                              emitted * step_flops(ch)),
                        chain_bound_ms=per * ch["cycles_per_step"],
                        chain_bound_ms_l2=per * ch["cycles_per_step_l2"],
                        cycles_per_step=ms / per, emitted=emitted,
                        shape=f"C={C} nsamp={n} {sampler} exact"
                              f"{'' if fs == 4e6 else ' 2.4 Msps'}")
    ht = receiver_hs.hs_tables(dev)
    n = 1 << 17
    htab = sum(ht[k].numel() * ht[k].element_size()
               for k in ("polar_a16", "rect16", "polar_w"))
    for key, omega, src in (("hs", 2.0, frames[:1]), ("hs 1.2", 1.2, x24)):
        hp = receiver_hs.HsParams(omega=omega)
        x = torch.clamp(torch.round(src[:, :n + 1] * (40 / 75.0) + 128), 0,
                        255).to(torch.int32).contiguous()
        st, _ = receiver_hs.run_chunks_hs(
            hp, ht, receiver_hs.init_state(hp, 1, dev), x)
        ms = cuda_time(lambda: receiver_hs.run_chunks_hs(hp, ht, st, x),
                       reps=3)
        per = n / clock * 1e3
        out[key] = dict(ms=ms, bound=bound_ms(x.numel() * 4 + htab + n * 4,
                                              n * step_flops(chains["hs"])),
                        chain_bound_ms=per * chains["hs"]["cycles_per_step"],
                        cycles_per_step=ms / per,
                        shape=f"C=1 nsamp={n} omega {omega}")
    for k, v in out.items():
        print(f"kernel scan/{k} {v['shape']}: {v['ms']:.3f} ms "
              f"({v['cycles_per_step']:.1f} cycles per "
              f"{'sample' if k.startswith('hs') else 'emitted symbol'}), "
              f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), serial chain "
              f"{v['chain_bound_ms']:.3f} ms" + (
                  f" (gathers at L2: {v['chain_bound_ms_l2']:.3f})"
                  if "chain_bound_ms_l2" in v else ""))
    return out


def brickwall(dev):
    """ROADMAP item 24, printed, not a gate: MER and lock of the single
    carrier on BRICKWALL_SAMPLES of a 2 Msym/s rate-1/2 carrier at 2.4
    Msps behind a brick-wall front end (resample_poly(z, 6, 5), no noise;
    f32 at unit rms, --float-scale 75, --anf 0, Finfo 500) on the kernel
    path (computed decisions, linear sampler) and on the exact-LUT
    polyphase path (--exact-lut --sampler rrc), in 2^17-sample reads."""
    from scipy.signal import resample_poly
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    n = BRICKWALL_SAMPLES
    npkt = int(n / 1.2 * 2 / 1632) + 16
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 6, 5)[:n]
    x = np.stack([z.real, z.imag], -1).astype(np.float32)
    x *= np.float32(1.0 / np.sqrt(np.mean(np.abs(z) ** 2) / 2))
    out = {}
    for name, fields in (("kernel linear", {}),
                         ("exact rrc", dict(exact_lut=True, sampler="rrc"))):
        cfg = RxConfig(**(dict(Fs=2.4e6, Fm=2e6, rate="1/2", anf=0,
                               float_scale=75.0, Finfo=500.0,
                               exact_lut=False) | fields))
        rx = DvbsReceiver(cfg, device=dev)
        npk = 0
        for o in range(0, n, 1 << 17):
            npk += len(rx.process(x[o:o + (1 << 17)]))
        mer = np.array(rx.meas["mer"])
        tail = mer[len(mer) // 2:]
        out[name] = dict(mer_median=float(np.median(tail)),
                         mer_min=float(tail.min()), mer_max=float(tail.max()),
                         lock=bool(rx.lock), packets=npk)
        print(f"[item 24 brick-wall, {name}] {n} samples: MER "
              f"{tail.min():.2f}..{tail.max():.2f} dB (median "
              f"{np.median(tail):.2f}) over the last {len(tail)} readings; "
              f"lock {rx.lock}, TS packets {npk}")
    return out

# ------------------------------ slice 7: the pipe, --awgn and --hdlc

# A port CLI in a child process: `python -c APP_WRAPPER OUT.json MODULE
# ARGS...` runs MODULE as __main__ with ARGS and writes its kernel launch
# counts and main()'s seconds to OUT.json at exit.
APP_WRAPPER = """
import atexit, json, runpy, sys, time
from chip_smoke import Launches
out, module = sys.argv[1], sys.argv[2]
counted = Launches()
t0 = time.perf_counter()
def dump():
    with open(out, "w") as f:
        json.dump(dict(launches=counted.read(),
                       main_s=time.perf_counter() - t0), f)
atexit.register(dump)
sys.argv = [module.rsplit(".", 1)[1]] + sys.argv[3:]
runpy.run_module(module, run_name="__main__")
"""


def pipe_path(dev):
    """The repo's canonical drive (the verify notes' pipe) with every
    stage from the port, each a child process: `leantsgen -c
    PIPE_PACKETS | leandvbtx -f 2 --cr 1/2 | leanchansim --if32 --of32
    --awgn PIPE_AWGN_DB --deterministic | leandvb --f32 --float-scale 75
    -f 4e6 --sr 2e6 --anf 0 --fastlock` (leandvb through APP_WRAPPER,
    which writes its kernel launch counts at exit). First each stage
    alone, from a file of the bytes of the one before to a file
    (timed), then the whole pipe (timed), whose TS must equal the
    stage-by-stage run's. The stages' ends are files, or the pipes
    between them, which this process neither reads nor writes: no
    stage's progress waits on this process polling it (a stage fed and
    drained through Popen.communicate has been seen to stall). Gate:
    LOCK 1 on --fd-info, the demod kernel launched, >= 90% of the packets sent after lock out equal
    (check_packets)."""
    import signal
    import tempfile
    py = sys.executable
    mod = [py, "-m"]
    gen = mod + ["leansdr_tpu_torch.apps.leantsgen", "-c", str(PIPE_PACKETS)]
    tx = mod + ["leansdr_tpu_torch.apps.leandvbtx", "-f", "2", "--cr", "1/2"]
    ch = mod + ["leansdr_tpu_torch.apps.leanchansim", "--if32", "--of32",
                "--awgn", str(PIPE_AWGN_DB), "--deterministic"]
    rx_args = ["--f32", "--float-scale", "75", "-f", "4e6", "--sr", "2e6",
               "--anf", "0", "--fastlock", "--fd-info", "2"]
    root = Path(__file__).resolve().parent
    # A stage past its time is sent SIGABRT: Python's fault handler then
    # prints every thread's stack on its stderr, which the failure shows.
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    alone = {}

    def wait(name, procs, errf):
        t = time.perf_counter()
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, PIPE_TIMEOUT_S
                                      - (time.perf_counter() - t)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.send_signal(signal.SIGABRT)
                time.sleep(5)
                for q in procs:
                    q.kill()
                fail(f"{name} still running after {PIPE_TIMEOUT_S} s:\n"
                     + errf.read_text(errors="replace")[-6000:])
        if any(p.returncode for p in procs):
            fail(f"{name}: exit codes {[p.returncode for p in procs]}:\n"
                 + errf.read_text(errors="replace")[-3000:])

    def run(name, cmd, src, dst, tmp):
        errf = tmp / f"{name}.err"
        t = time.perf_counter()
        with open(src, "rb") as fi, open(dst, "wb") as fo, \
                open(errf, "wb") as fe:
            proc = subprocess.Popen(cmd, cwd=root, stdin=fi, stdout=fo,
                                    stderr=fe, env=env)
        CHILDREN.append(proc)
        wait(f"pipe: {name}", [proc], errf)
        alone[name] = time.perf_counter() - t
        print(f"[pipe] {name} alone: {alone[name]:.3f} s", flush=True)

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        rx = [py, "-c", APP_WRAPPER, str(tmp / "alone.json"),
              "leansdr_tpu_torch.apps.leandvb"] + rx_args
        run("leantsgen", gen, os.devnull, tmp / "ts", tmp)
        run("leandvbtx", tx, tmp / "ts", tmp / "iq", tmp)
        run("leanchansim", ch, tmp / "iq", tmp / "noisy", tmp)
        run("leandvb", rx, tmp / "noisy", tmp / "ts_alone", tmp)
        rec_alone = json.loads((tmp / "alone.json").read_text())
        rx[3] = str(tmp / "pipe.json")
        errf = tmp / "pipe.err"
        t = time.perf_counter()
        procs, src = [], subprocess.DEVNULL
        with open(tmp / "ts_pipe", "wb") as fo, open(errf, "wb") as fe:
            for cmd in (gen, tx, ch, rx):
                last = cmd is rx
                procs.append(subprocess.Popen(
                    cmd, cwd=root, stdin=src,
                    stdout=fo if last else subprocess.PIPE,
                    stderr=fe, env=env))
                CHILDREN.append(procs[-1])
                if src is not subprocess.DEVNULL:
                    src.close()         # the next stage owns the pipe
                src = procs[-1].stdout
        wait("pipe", procs, errf)
        wall = time.perf_counter() - t
        rec = json.loads((tmp / "pipe.json").read_text())
        ts = (tmp / "ts_pipe").read_bytes()
        if ts != (tmp / "ts_alone").read_bytes():
            fail("pipe: the piped TS differs from the stage-by-stage run's")
        info = errf.read_text(errors="replace").splitlines()
        nsamp = (tmp / "noisy").stat().st_size // 8
    launches = rec["launches"]
    locks = [ln for ln in info if ln.startswith("LOCK ")]
    lock = bool(locks) and locks[-1] == "LOCK 1"
    pkts = list(np.frombuffer(ts[:len(ts) // 188 * 188], np.uint8)
                .reshape(-1, 188))
    n_after, n_good, span = check_packets(0, pkts)
    signal_s = nsamp / 4e6
    res = dict(packets_sent=PIPE_PACKETS, samples=nsamp, signal_s=signal_s,
               wall_s=wall, x_real_time=signal_s / wall,
               stage_alone_s=alone,
               receiver_main_s=rec["main_s"],
               receiver_alone_main_s=rec_alone["main_s"],
               x_real_time_receiver_alone=signal_s / alone["leandvb"],
               launches=launches, lock=lock, packets_good=int(n_good),
               packets_after_lock=int(n_after), span=int(span),
               info_last={tag: next((ln for ln in reversed(info)
                                     if ln.startswith(tag + " ")), None)
                          for tag in ("MER", "LOCK", "VBER")})
    print(f"[pipe] leantsgen -c {PIPE_PACKETS} | leandvbtx | leanchansim "
          f"--awgn {PIPE_AWGN_DB} | leandvb: {nsamp} samples "
          f"({signal_s:.3f} s of signal), wall {wall:.3f} s "
          f"({res['x_real_time']:.3f}x real time); each stage alone "
          "(wall, process start included): " + ", ".join(
              f"{k} {v:.3f} s" for k, v in alone.items())
          + f"; leandvb main() {rec['main_s']:.3f} s in the pipe, "
          f"{rec_alone['main_s']:.3f} s alone; launches {launches}; lock "
          f"{lock}; {n_good} sent packets of {n_after} after lock (span "
          f"{span}); last --fd-info lines {list(res['info_last'].values())}")
    if launches["demod"] < 1:
        fail(f"pipe: leandvb did not launch the demod kernel: {launches}")
    if not lock or n_good < 100 or n_good < 0.9 * max(n_after, span):
        fail(f"pipe: {n_good} sent packets decoded of {n_after} after lock, "
             f"span {span}, lock {lock}")
    return res


def awgn_path(dev, rng, stimuli):
    """The receiver's own --awgn: AWGN_SECONDS of a clean 2 Msym/s rate-1/2
    carrier at 4 Msps f32 (sc_stimulus as for hq 1/2, no noise of its
    own) through DvbsReceiver with awgn set for Es/N0 = AWGN_ESN0_DB
    (--anf 0, --fastlock, hard decisions on the demod kernel), gated and
    replayed against the plain versions as every single-carrier path;
    the same stream without --awgn beside it, for the MER the noise
    costs."""
    fields = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, anf=0,
                  float_scale=75.0)
    # Unit rms per component, 75 after --float-scale, 2 samples per
    # symbol: Es = 2 * 2 * 75^2; the noise's N0 = 2 sigma^2 per sample.
    sigma = float(np.sqrt(2 * 2 * 75.0 ** 2 / 10 ** (AWGN_ESN0_DB / 10)
                          / 2))
    args = ("f32", AWGN_SECONDS, (3, 3, True), 20e3, np.inf, None)
    clean = single_carrier(dev, rng, stimuli, "awgn off", fields, *args)
    noisy = single_carrier(dev, rng, stimuli, "awgn",
                           fields | {"awgn": sigma}, *args)
    print(f"[awgn] --awgn {sigma:.4f} (Es/N0 {AWGN_ESN0_DB:g} dB): MER "
          f"{noisy['mer_db']:.2f} dB, without --awgn {clean['mer_db']:.2f}"
          " dB")
    if not noisy["mer_db"] < clean["mer_db"] - 1.0:
        fail("awgn: the MER does not show the noise")
    noisy["awgn_sigma"] = sigma
    noisy["mer_db_without_awgn"] = clean["mer_db"]
    return clean, noisy


def hdlc_encode(frames) -> np.ndarray:
    """HDLC bit stream of `frames`: opening and closing flags, each frame
    LSB first with its CRC16-CCITT (reflected 0x8408, init 0xffff, sent
    inverted) behind it, a 0 stuffed after five 1s, packed MSB first."""
    bits = [0, 1, 1, 1, 1, 1, 1, 0]
    for f in frames:
        crc = 0xFFFF
        for b in f:
            crc ^= int(b)
            for _ in range(8):
                crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        crc ^= 0xFFFF
        ones = 0
        for b in list(f) + [crc & 0xFF, crc >> 8]:
            for k in range(8):
                bit = (int(b) >> k) & 1
                bits.append(bit)
                ones = ones + 1 if bit else 0
                if ones == 5:
                    bits.append(0)
                    ones = 0
        bits += [0, 1, 1, 1, 1, 1, 1, 0]
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8))


def hdlc_stimulus(rng, seconds):
    """f32 wire bytes of `seconds` of one 2 Msym/s carrier at 4 Msps
    (unit rms, 20 kHz off, Es/N0 20 dB) carrying random frames of
    HDLC_FRAME_BYTES: HDLC-framed (hdlc_encode), ETR192-scrambled, the
    rate-1/2 convolutional code, QPSK, the modulator's RRC at 2 samples
    per symbol, resampled as sc_stimulus does for hq 1/2. Returns
    (bytes, frames sent)."""
    from scipy.signal import resample_poly
    from leansdr_tpu_torch.dsp import filtergen
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec import convenc
    from leansdr_tpu_torch.proto.hdlc import etr192_scramble
    n = int(round(seconds * 4e6))
    lo, hi = HDLC_FRAME_BYTES
    # Bits of 2 samples per symbol, one bit per symbol, ~1.03 per byte
    # for flags and stuffing.
    nframes = int(n / 2 / 8 / ((lo + hi) / 2 + 3.2)) + 16
    frames = [rng.integers(0, 256, int(rng.integers(lo, hi + 1)),
                           dtype=np.uint8) for _ in range(nframes)]
    data, _, _ = etr192_scramble(hdlc_encode(frames))
    syms, _ = convenc.encode(data, "1/2", 2)
    pts = make_dvbs2_constellation(Predef.QPSK, "1/2").symbols
    up = np.zeros(2 * len(syms), np.complex128)
    up[::2] = pts[syms, 0] + 1j * pts[syms, 1]
    z = np.convolve(up, filtergen.root_raised_cosine(20, 0.5, 0.35))
    z = resample_poly(z, 3, 1)[3::3]
    if len(z) < n:
        fail(f"hdlc stimulus: {len(z)} samples < {n}")
    z = z[:n] * np.exp(2j * np.pi * 20e3 / 4e6 * np.arange(n))
    ps = float(np.mean(np.abs(z) ** 2))
    sigma = np.sqrt(ps * 2 / 10 ** (20 / 10) / 2)
    z = z + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = np.stack([z.real, z.imag], -1).reshape(-1)
    x /= np.sqrt(np.mean(np.abs(z) ** 2) / 2)
    return x.astype(np.float32).tobytes(), [f.tobytes() for f in frames]


def check_frames(out: bytes, sent: list):
    """--hdlc --packetized output ([u16 big-endian length][frame] ...)
    against the frames sent: from the first frame that equals a sent one
    on, how many are sent frames, and how many of the frames sent in that
    span came out. Returns (n_after_lock, n_good, n_span)."""
    index = {f: i for i, f in enumerate(sent)}
    got, o = [], 0
    while o + 2 <= len(out):
        n = out[o] << 8 | out[o + 1]
        got.append(index.get(out[o + 2:o + 2 + n], -1))
        o += 2 + n
    if o != len(out):
        fail(f"hdlc: {len(out) - o} bytes past the last whole frame")
    ok = [i >= 0 for i in got]
    if not any(ok):
        return 0, 0, 1
    first = ok.index(True)
    good = sorted({i for i in got[first:] if i >= 0})
    return len(got) - first, len(good), good[-1] - good[0] + 1


def hdlc_path(dev, rng):
    """--hdlc --packetized on one carrier: hdlc_stimulus through
    DvbsReceiver (--anf 0, --fastlock, hard decisions on the demod
    kernel; the ETR192 descrambler and the HDLC sync on the host, each
    timed apart), gated on its frames and replayed against the plain
    versions as every single-carrier path."""
    t0 = time.perf_counter()
    stim = hdlc_stimulus(rng, HDLC_SECONDS)
    print(f"[hdlc] {len(stim[1])} frames of {HDLC_FRAME_BYTES[0]}.."
          f"{HDLC_FRAME_BYTES[1]} bytes framed, scrambled and modulated in "
          f"{time.perf_counter() - t0:.1f} s")
    fields = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, anf=0,
                  float_scale=75.0, hdlc=True, packetized=True)
    return single_carrier(dev, rng, {}, "hdlc", fields, "f32", HDLC_SECONDS,
                          (3, 3, True), 20e3, 20.0, None, stimulus=stim)



# ---------------------------------------------------------------- phase 5

# ------------------------------ slice 9: TX, the candidate scan, FM

# The device modulator's cases (constellation, rate), interp 2, each on
# 64 carriers' packets numbered as fleet_stimulus numbers them (enough
# for its SEG_CHUNKS chunks); TX_CHECKED carriers are held against the
# same function on the CPU (equal) and the host modulator (1e-5).
TX_CASES = (("QPSK", "1/2"), ("QPSK", "3/4"), ("QPSK", "7/8"),
            ("PSK8", "2/3"))
TX_CHECKED = (0, NCHAN - 1)
# The candidate scan: 2 s of u8 at SCAN_FS carrying 2 Msym/s at rate
# SCAN_RATE behind the canonical stream's fold-back front end (SC_PATHS'
# (6, 10, True): not the brick wall of item 24), +20 kHz, 20 dB; read
# SCAN_READ samples at a time (leansdrscan's read); the launches
# SCAN_CAPTURE (by index) held against run_chunks_ref on their first
# SCAN_PLAIN samples.
SCAN_SECONDS = 2.0
SCAN_RATE = "3/4"
SCAN_READ = 1 << 16
SCAN_CAPTURE = (0, 20)
# The FM receiver: leanmlmrx's defaults (--fs 25.6e6, N=64, --fa 44100:
# Fq 176.4 kHz, audio decimation 4) over MAXCHANS = 201 channels,
# 87.6-107.6 MHz in 100 kHz steps around --fc 97.6e6; FM_SECONDS of s16
# with FM_TONED channels carrying tones (FM_TONES, FM_DEV peak deviation,
# amplitude 1000 each) and noise (sigma 30); --squelch FM_SQUELCH (a
# carrier's mean square discriminator output ~0.04 of full scale stays
# under 1 - 0.8, a dead channel's uniform phase steps, ~1/3, go over it:
# tests/test_torch_mlm.py). The per-channel and CPU checks read the first
# FM_PREFIX samples; the CLI reads 2^20 samples at a time.
FM_FS, FM_FC = 25.6e6, 97.6e6
FM_CHANNELS = "87.6:0.1:107.6"
FM_TONED = tuple(range(0, 201, 25))
FM_TONES = tuple(500.0 + 300.0 * i for i in range(len(FM_TONED)))
FM_DEAD = 12
FM_DEV = 25e3
FM_SQUELCH = 0.8
FM_SECONDS = 1.0
FM_PREFIX = 1 << 21
FM_READ = 1 << 20
# Slice 10 (multi_path): the sharded FIR over MULTI_HALO complex samples
# (rrc taps 32/0.25/0.35, tools/dcn_demo.py's); the ring over the first 2
# carriers in blocks of MULTI_RING_BLOCK samples; the multihost fleet and
# its single-process twin over MULTI_WINDOWS chunks of CHUNK_SAMPLES;
# DeviceFeeder over MULTI_FEED chunks of NCHAN x CHUNK_SAMPLES; the host
# to device rate over MULTI_H2D_REPS copies of one such chunk.
MULTI_HALO = 1 << 24
MULTI_RING_BLOCK = 1 << 16
MULTI_WINDOWS = 4
MULTI_FEED = 16
MULTI_H2D_REPS = 10
MULTI_TIMEOUT_S = 300



def tx_path(dev) -> dict:
    """The device modulator (pipelines/dvbs_tx_device.DeviceModulator on
    the card) at TX_CASES on NCHAN carriers' packets, one modulate call
    per carrier: Msamples/s out over the 64 calls (host clock around
    them, synchronized); carriers TX_CHECKED equal to the same function
    on the CPU and within 1e-5 of the port's host dvbs_tx.modulate after
    the RRC latency (tests/test_tx_golden.py's alignment). No
    hand-written kernel: torch ops and one float32 matmul (TF32 off)."""
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_tpu_torch.fec.convenc import FEC_SPECS
    from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
    from leansdr_tpu_torch.pipelines.dvbs_tx_device import DeviceModulator
    nsamp = SEG_CHUNKS * CHUNK_SAMPLES
    out = {}
    for const, rate in TX_CASES:
        mod = DeviceModulator(Predef[const], rate, interp=2, device=dev)
        cpu = DeviceModulator(Predef[const], rate, interp=2, device="cpu")
        bps = make_dvbs2_constellation(Predef[const], rate).bits_per_symbol
        bits_in, bits_out = FEC_SPECS[mod.rate]
        npkt = nsamp * bps * bits_in // (1504 * bits_out * 2) + 16
        pk = [torch.from_numpy(tsgen.generate(npkt, start=1000 * c)).to(dev)
              for c in range(NCHAN)]
        mod.modulate_tensor(pk[0])                      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        ys = [mod.modulate_tensor(p) for p in pk]
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        nout = sum(y.shape[0] for y in ys)
        err = 0.0
        for c in TX_CHECKED:
            got = ys[c].cpu().numpy()
            if not np.array_equal(got, cpu.modulate(pk[c].cpu().numpy())):
                fail(f"tx {const} {rate} carrier {c}: the card's IQ != the "
                     "CPU's")
            host = dvbs_tx.modulate(pk[c].cpu().numpy(), dvbs_tx.TxConfig(
                constellation=Predef[const], rate=rate, interp=2))
            lat = (mod.ncoeffs + 2) // 2
            seg = got[lat * 2: lat * 2 + len(host)]
            if len(seg) != len(host):
                fail(f"tx {const} {rate}: {len(seg)} samples after the "
                     f"latency, host {len(host)}")
            err = max(err, float(np.abs(host - seg).max()))
        if err >= 1e-5:
            fail(f"tx {const} {rate}: {err} from the host modulator")
        key = f"{const} {rate}"
        out[key] = dict(msamples_per_s=nout / s / 1e6, samples=nout,
                        seconds=s, packets=NCHAN * npkt, host_max_err=err)
        print(f"[tx {key}] {NCHAN} carriers x {npkt} packets -> {nout} "
              f"samples in {s * 1e3:.1f} ms: {nout / s / 1e6:.1f} "
              f"Msamples/s out; carriers {TX_CHECKED} == CPU, "
              f"{err:.2e} from the host modulator")
    return out


def scan_path(dev, rng, chains, clock) -> dict:
    """The candidate scan on the reference's 4 SR x 5 CR grid
    (SCAN_SRS x SCAN_CRS at SCAN_FS), in process through
    CandidateScanReceiver (leansdrscan --device's loop: SCAN_READ-sample
    reads until a candidate puts out TS, then focus() and on to the end),
    its counters zeroed just before and read just after, then through
    `python -m leansdr_tpu_torch.apps.leansdrscan --device` in a child
    process (APP_WRAPPER: its counts at exit) without --rewind. Gates:
    both elect (2e6, SCAN_RATE), >= 90% of the packets sent after lock
    out equal (check_packets), scan_demod launched; the SCAN_CAPTURE
    launches == run_chunks_ref on SCAN_PLAIN samples. Time to election,
    x real time, the host chains' seconds, and the per-channel kernel's
    ms per launch (CUDA events, a mid-stream launch again) beside its
    bytes and serial-chain bounds."""
    import tempfile
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.scan_rx import CandidateScanReceiver
    from leansdr_tpu_torch.util.iofmt import read_iq
    raw, npkt = sc_stimulus("QPSK", SCAN_RATE, SCAN_FS, SCAN_SECONDS,
                            (6, 10, True), 20e3, 20.0, None, "u8", rng)
    n = len(raw) // 2
    want = SCAN_SRS.index(2e6) * len(SCAN_CRS) + SCAN_CRS.index(SCAN_RATE)

    def grid():
        return CandidateScanReceiver.grid(SCAN_FS, SCAN_SRS, SCAN_CRS,
                                          device=dev)
    warm = grid()
    warm.process(np.zeros((receiver.CHUNK + warm.params.readahead, 2),
                          np.float32))
    del warm
    scan = grid()
    orig, feed = receiver.run_chunks, multi_rx._ByteChain.feed
    calls, captured, host = [0], [], dict(chains=0.0, read=0.0)

    def recorded(p, tables, st, x):
        if calls[0] in SCAN_CAPTURE:
            captured.append((p, tables, _clone(st), x.clone()))
        calls[0] += 1
        return orig(p, tables, st, x)

    def timed_feed(self, syms):
        t = time.perf_counter()
        try:
            return feed(self, syms)
        finally:
            host["chains"] += time.perf_counter() - t

    def read(o):
        t = time.perf_counter()
        iq = read_iq(raw[2 * o:2 * (o + SCAN_READ)], "u8")
        host["read"] += time.perf_counter() - t
        return iq

    counted = Launches()
    receiver.run_chunks, multi_rx._ByteChain.feed = recorded, timed_feed
    counted.zero()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, winner = 0, None
        while winner is None and o < n:
            winner = scan.process(read(o))
            o += SCAN_READ
        elect_s, elect_samples = time.perf_counter() - t0, min(o, n)
        if winner != want:
            fail(f"scan: elected {winner}, not {want} (2e6, {SCAN_RATE})")
        pkts = [scan.outputs[winner]]
        scan.focus(winner)
        scan.outputs[0] = scan.outputs[0][:0]
        while o < n:
            scan.process(read(o))
            o += SCAN_READ
        pkts.append(scan.outputs[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        launches = counted.read()
        receiver.run_chunks, multi_rx._ByteChain.feed = orig, feed
    n_after, n_good, span = check_packets(0, list(np.concatenate(pkts)))
    if launches[SCAN_PC] < 1 or not (
            n_good >= 100 and n_good >= 0.9 * max(n_after, span)):
        fail(f"scan: {n_good} sent packets of {n_after} after lock (span "
             f"{span}); launches {launches}")
    checked, err = [], 0.0
    for p, tables, st, x in captured:
        xs = x[:, :SCAN_PLAIN + p.readahead].contiguous()
        _, ms, e = _scan_compare("scan launch", orig, receiver.run_chunks_ref,
                                 (p, tables, st, xs))
        checked.append((x.shape[0], ms))
        err = max(err, e)
    # The kernel at the path's two shapes: the grid's first launch (C=4,
    # cold state) and a launch after focus() (C=1, the winner's lane).
    shapes = []
    for p, tables, st, x in captured:
        ms = cuda_time(lambda: orig(p, tables, st, x), reps=3)
        _, o1 = orig(p, tables, st, x)
        C, n1 = x.shape[0], x.shape[1] - p.readahead
        emitted = o1["valid"].sum(1)
        if p.sampler != "linear" or p.exact_lut:
            fail(f"scan: a {p.sampler} exact_lut={p.exact_lut} launch, not "
                 "the linear computed instance its bound is read from")
        nbytes = (x.numel() * 4 + scan_table_bytes(tables, p) + C * n1 * 4
                  + C * (n1 // receiver.CHUNK) * 24 + 2 * C * 21 * 4
                  + C * 20)
        ch = chains["linear computed"]
        per = float(emitted.max()) / clock * 1e3     # the busiest channel
        shapes.append(dict(
            ms=ms, bound=bound_ms(nbytes,
                                  float(emitted.sum()) * step_flops(ch)),
            chain_bound_ms=per * ch["cycles_per_step"],
            chain_bound_ms_l2=per * ch["cycles_per_step_l2"],
            emitted=[int(v) for v in emitted],
            shape=f"C={C} nsamp={n1} linear computed, per-channel omega "
                  f"{[round(v, 4) for v in st['omega'].tolist()]}"))
    kern = dict(shapes[0], plain=checked, focused=shapes[-1], err=err)
    signal_s = n / SCAN_FS
    res = dict(launches=launches, samples=n, signal_s=signal_s,
               elect_s=elect_s, elect_samples=elect_samples, wall_s=wall,
               x_real_time=signal_s / wall, host_s=host,
               packets_good=int(n_good), packets_after_lock=int(n_after),
               kernel=kern)
    print(f"[scan] {len(SCAN_SRS)} SR x {len(SCAN_CRS)} CR on "
          f"{len(SCAN_SRS)} lanes: elected (2e6, {SCAN_RATE}) after "
          f"{elect_samples} samples ({elect_samples / SCAN_FS:.3f} s of "
          f"signal) in {elect_s:.3f} s; whole {signal_s:.2f} s in "
          f"{wall:.3f} s ({res['x_real_time']:.3f}x real time); host "
          f"chains {host['chains']:.3f} s, reads {host['read']:.3f} s; "
          f"launches {launches}; {n_good} sent packets of {n_after} after "
          f"lock (span {span}); launches {SCAN_CAPTURE} == run_chunks_ref "
          f"on {SCAN_PLAIN} samples (plain ms {[m for _, m in checked]})")
    for v in shapes:
        print(f"kernel scan/per-channel {v['shape']}: {v['ms']:.3f} ms, "
              f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), serial "
              f"chain {v['chain_bound_ms']:.3f} ms (gathers at L2 "
              f"{v['chain_bound_ms_l2']:.3f}); emitted {v['emitted']}")

    root = Path(__file__).resolve().parent
    args = ["--device", "-t", "600", sys.executable, "-m",
            "leansdr_tpu_torch.apps.leandvb", "--u8", "-f", f"{SCAN_FS:g}",
            "--sr", ",".join(f"{v:g}" for v in SCAN_SRS),
            "--cr", ",".join(SCAN_CRS)]
    with tempfile.TemporaryDirectory() as d:
        src, js = Path(d) / "scan.u8", Path(d) / "scan.json"
        src.write_bytes(raw)
        t = time.perf_counter()
        with open(src, "rb") as f:
            proc = subprocess.Popen([sys.executable, "-c", APP_WRAPPER,
                                     str(js), "leansdr_tpu_torch.apps."
                                     "leansdrscan"] + args, cwd=root, stdin=f,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            CHILDREN.append(proc)
            ts, err = proc.communicate(timeout=600)
        cli_wall = time.perf_counter() - t
        err = err.decode(errors="replace")
        if proc.returncode != 0:
            fail(f"leansdrscan --device exited {proc.returncode}:\n"
                 + err[-3000:])
        rec = json.loads(js.read_text())
    elected = [ln for ln in err.splitlines()
               if ln.startswith("Device scan elected")]
    if not elected or f"--sr 2e+06 --cr {SCAN_RATE}" not in elected[0] \
            or "continuing in-process" not in elected[0]:
        fail(f"leansdrscan --device: {elected or err[-2000:]}")
    c_after, c_good, c_span = check_packets(
        0, list(np.frombuffer(ts, np.uint8).reshape(-1, 188)))
    if rec["launches"][SCAN_PC] < 1 or not (
            c_good >= 100 and c_good >= 0.9 * max(c_after, c_span)):
        fail(f"leansdrscan --device: {c_good} sent packets of {c_after} "
             f"after lock (span {c_span}); launches {rec['launches']}")
    res["cli"] = dict(wall_s=cli_wall, main_s=rec["main_s"],
                      x_real_time_wall=signal_s / cli_wall,
                      x_real_time_main=signal_s / rec["main_s"],
                      launches=rec["launches"], elected=elected[0],
                      packets_good=int(c_good),
                      packets_after_lock=int(c_after))
    print(f"[leansdrscan --device] {elected[0]}; wall {cli_wall:.2f} s "
          f"({signal_s / cli_wall:.3f}x real time; main "
          f"{rec['main_s']:.2f} s), launches {rec['launches']}; {c_good} "
          f"sent packets of {c_after} after lock (span {c_span})")
    return res


def fm_stimulus(dev, gen) -> np.ndarray:
    """FM_SECONDS of leanmlmrx's s16 input, [n, 2] int16: FM_TONED
    channels carrying FM_TONES at FM_DEV, noise of sigma 30 (float64
    phases on the card, seeded)."""
    n = int(FM_SECONDS * FM_FS)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    re = 30.0 * torch.randn(n, dtype=torch.float64, device=dev,
                            generator=gen)
    im = 30.0 * torch.randn(n, dtype=torch.float64, device=dev,
                            generator=gen)
    for k, tone in zip(FM_TONED, FM_TONES):
        f = 87.6e6 + 0.1e6 * k - FM_FC
        ph = (2 * np.pi * f / FM_FS * t
              + FM_DEV / tone * torch.sin(2 * np.pi * tone / FM_FS * t))
        re += 1000.0 * torch.cos(ph)
        im += 1000.0 * torch.sin(ph)
    s16 = torch.stack([re, im], -1).round().clamp(-32768, 32767)
    return s16.to(torch.int16).cpu().numpy()


def _tone(au, fau) -> float:
    """The audio's spectral peak (Hz) over 2048 samples from the 500th
    (tests/test_mlm.py)."""
    w = au[500:500 + 2048].astype(np.float64) * np.hanning(2048)
    sp = np.abs(np.fft.rfft(w))
    return float(np.fft.rfftfreq(2048, 1 / fau)[np.argmax(sp[5:]) + 5])


def fm_path(dev, gen) -> dict:
    """leanmlmrx at its defaults over 201 channels (FM_*), on the card.
    In process, on the first FM_PREFIX samples: each toned channel alone
    peaks at its tone within 50 Hz, a dead channel squelched is silent,
    and the 201-channel mix equals a CPU run within
    tests/test_torch_mlm.py's bar (1 LSB at under 1 in 10^3 samples);
    then the whole input through MlmReceiver in FM_READ reads as the CLI
    reads it (x real time; channelize's device ms from CUDA events, the
    host stages: the s16 conversion and process() by the host clock).
    Then `python -m leansdr_tpu_torch.apps.leanmlmrx --fs ... --squelch
    FM_SQUELCH 87.6:0.1:107.6` in a child process on the same FM_SECONDS
    of s16 (x real time): its audio must equal the in-process run's byte
    for byte. The mix's level at each tone (x the spectrum's median) is
    printed, not gated: the channels next to a carrier take its skirt
    and pass the squelch."""
    import tempfile
    from leansdr_tpu_torch.apps import leanmlmrx
    from leansdr_tpu_torch.pipelines import mlm_rx
    s16 = fm_stimulus(dev, gen)
    chans = []
    leanmlmrx.parse_channel(chans, FM_CHANNELS, mlm_rx.Channel)
    if len(chans) != mlm_rx.MAXCHANS:
        fail(f"fm: {FM_CHANNELS} gives {len(chans)} channels")
    freqs = [c.F for c in chans]

    def cfg(fs, squelch=0.0):
        return mlm_rx.MlmConfig(Fs=FM_FS, Fc=FM_FC, squelch=squelch,
                                channels=[mlm_rx.Channel(F=f) for f in fs])

    def iq_of(a):
        return (a[:, 0].astype(np.float32)
                + 1j * a[:, 1].astype(np.float32)).astype(np.complex64)
    pre = iq_of(s16[:FM_PREFIX])
    tones = {}
    for k, tone in zip(FM_TONED, FM_TONES):
        rx = mlm_rx.MlmReceiver(cfg([freqs[k]]), device=dev)
        tones[k] = _tone(rx.process(pre), rx.Fau)
        if abs(tones[k] - tone) >= 50:
            fail(f"fm channel {k}: audio peaks at {tones[k]} Hz, tone {tone}")
    dead = mlm_rx.MlmReceiver(cfg([freqs[FM_DEAD]], FM_SQUELCH), device=dev)
    dead_mean = float(np.abs(dead.process(pre).astype(np.float64)).mean())
    if dead_mean >= 1:
        fail(f"fm: the dead channel {FM_DEAD} squelched gives mean |audio| "
             f"{dead_mean}")
    runs = [mlm_rx.MlmReceiver(cfg(freqs, FM_SQUELCH), device=d).process(pre)
            for d in (dev, "cpu")]
    diff = np.abs(runs[0].astype(int) - runs[1].astype(int))
    if (len(runs[0]) != len(runs[1]) or diff.max() > 1
            or (diff > 0).sum() > len(diff) // 1000):
        fail(f"fm: the card's audio != the CPU's: {(diff > 0).sum()} of "
             f"{len(diff)} samples differ, max {diff.max()}")

    # The whole input, as the CLI reads it, timed by stage.
    rx = mlm_rx.MlmReceiver(cfg(freqs, FM_SQUELCH), device=dev)
    orig, events, host = mlm_rx.channelize, [], dict(convert=0.0, process=0.0)

    def timed(*a):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        r = orig(*a)
        e.record()
        events.append((s, e))
        return r
    mlm_rx.channelize = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = []
        for o in range(0, len(s16), FM_READ):
            t = time.perf_counter()
            iq = iq_of(s16[o:o + FM_READ])
            t1 = time.perf_counter()
            whole.append(rx.process(iq))
            t2 = time.perf_counter()
            host["convert"] += t1 - t
            host["process"] += t2 - t1
        wall = time.perf_counter() - t0
    finally:
        mlm_rx.channelize = orig
    chz_ms = sum(s.elapsed_time(e) for s, e in events)
    frames = int(round(len(s16) / rx.stride))

    root = Path(__file__).resolve().parent
    args = ["--fs", f"{FM_FS:g}", "--fc", f"{FM_FC:g}", "--squelch",
            str(FM_SQUELCH), FM_CHANNELS]
    with tempfile.TemporaryDirectory() as d:
        src, js = Path(d) / "fm.s16", Path(d) / "fm.json"
        src.write_bytes(s16.tobytes())
        t = time.perf_counter()
        with open(src, "rb") as f:
            proc = subprocess.Popen([sys.executable, "-c", APP_WRAPPER,
                                     str(js), "leansdr_tpu_torch.apps."
                                     "leanmlmrx"] + args, cwd=root, stdin=f,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            CHILDREN.append(proc)
            audio, err = proc.communicate(timeout=600)
        cli_wall = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"leanmlmrx exited {proc.returncode}:\n"
                 + err.decode(errors="replace")[-3000:])
        rec = json.loads(js.read_text())
    whole = np.concatenate(whole)
    if audio != whole.tobytes() or len(whole) < 0.95 * FM_SECONDS * 44100:
        fail(f"leanmlmrx: {len(audio)} audio bytes, not the in-process "
             f"run's {len(whole)}")
    au = whole.astype(np.float64)
    seg = au[len(au) // 8:]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1 / 44100)
    floor = float(np.median(sp))
    mix = {}
    for tone in FM_TONES:
        near = np.abs(f - tone) < 50
        wide = np.abs(f - tone) < 150
        peak = float(f[wide][np.argmax(sp[wide])])
        mix[tone] = dict(level=float(sp[near].max()) / floor, peak_hz=peak)
    res = dict(channels=len(chans), frames=frames, signal_s=FM_SECONDS,
               wall_s=wall, x_real_time=FM_SECONDS / wall,
               channelize_ms=chz_ms, host_ms={k: v * 1e3
                                              for k, v in host.items()},
               tones_hz=tones, dead_mean_abs=dead_mean,
               card_vs_cpu_differ=int((diff > 0).sum()),
               cli=dict(wall_s=cli_wall, main_s=rec["main_s"],
                        x_real_time_wall=FM_SECONDS / cli_wall,
                        x_real_time_main=FM_SECONDS / rec["main_s"],
                        audio_samples=len(au), mix=mix))
    print(f"[fm] {len(chans)} channels, {frames} frames of N=64 per s: "
          f"in process {wall:.3f} s for {FM_SECONDS} s "
          f"({res['x_real_time']:.3f}x real time): channelize {chz_ms:.1f} "
          f"ms on the card (CUDA events), host: s16 conversion "
          f"{host['convert'] * 1e3:.1f} ms, process() "
          f"{host['process'] * 1e3:.1f} ms; leanmlmrx child wall "
          f"{cli_wall:.2f} s ({FM_SECONDS / cli_wall:.3f}x; main "
          f"{rec['main_s']:.2f} s, {FM_SECONDS / rec['main_s']:.3f}x); "
          f"tones {tones}; mix levels "
          f"{ {t: round(v['level'], 1) for t, v in mix.items()} }; dead "
          f"channel {dead_mean:.3f}; card vs CPU: {(diff > 0).sum()} of "
          f"{len(diff)} audio samples differ (max {diff.max()})")
    return res


def multi_rank_job(r: int, work: str):
    """A gloo rank of multi_path (`--multi-rank R WORK`), sharing the card
    with the other rank: the halo at D=2 over its half of the stream and
    the ring at D=2 over the first 2 carriers, with the kernels' launch
    counts zeroed just before and read just after; results to
    WORK/multi_out<R>.pt."""
    import torch.distributed as dist
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.parallel import group, halo, mesh, timeshard
    work = Path(work)
    a = torch.load(work / "multi_in.pt")
    dev = group.init(r, 2, f"file://{work / 'store'}", "gloo")
    counted = Launches()
    try:
        params = receiver.ReceiverParams(**a["params"])
        tables = {k: v.to(dev) for k, v in a["tables"].items()}
        state = {k: v[r:r + 1].to(dev) for k, v in a["state"].items()}
        x = a["x"]
        b = x.shape[1] // 2
        xb = x[:, r * b:(r + 1) * b].to(dev)
        ins = a["ins"][r].to(dev)
        fir = halo.sharded_fir(a["taps"].numpy())
        ring = timeshard.ring_stream_demod(params)
        torch.cuda.synchronize()
        counted.zero()
        y = fir(xb)
        st, outs = ring(tables, state, ins)
        torch.cuda.synchronize()
        launches = counted.read()
        st = mesh.gather_channels(st)
        outs = mesh.gather_channels(outs, dim=1)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    torch.save(dict(halo=y.cpu(), state={k: v.cpu() for k, v in st.items()},
                    outs={k: v.cpu() for k, v in outs.items()},
                    launches=launches, backend=backend),
               work / f"multi_out{r}.pt")


def _equal_trees(tag, want: dict, got: dict):
    for k in want:
        if not torch.equal(want[k], got[k]):
            fail(f"{tag}: {k} differs in "
                 f"{int((want[k] != got[k]).sum())} entries")


def multi_path(dev, gen, card) -> dict:
    """Slice 10: the parallel modules and the host ingest on the card.

    1. NCCL at world size 1 (this process): mesh.sharded_demod_step over
       NCHAN carriers x CHUNK_SAMPLES of the exact-LUT fleet's scan demod
       (the rrc sampler), equal to the unsharded run_chunks in every
       output and state plane, its mean MER the outputs' mean; and
       halo.sharded_fir over MULTI_HALO complex samples, equal to the
       unsharded fir and to fir_ref.
    2. Two gloo ranks sharing the card (`--multi-rank` children): the
       halo at D=2, equal to the unsharded fir; the ring at D=2 over the
       first 2 carriers (MULTI_RING_BLOCK-sample blocks), equal to the
       unsharded run_chunks in every output and its end state. Beside
       them `python -m leansdr_tpu_torch.parallel.multihost --world 2
       --backend gloo`: the NCHAN-carrier fleet, NCHAN/2 per rank, over
       MULTI_WINDOWS chunks, each carrier's TS written out.
    3. The single-process fleet over the same carriers and chunks, fed
       through DeviceFeeder: every carrier locks and decodes >= 90% of
       the packets sent after lock, and the ranks' TS equals it.
    4. DeviceFeeder over MULTI_FEED chunks of NCHAN x CHUNK_SAMPLES, each
       chunk's contents checked on the card while the fleet runs it; the
       consumer's wait for each chunk; the host-to-device rate from
       pinned and from pageable memory."""
    import dataclasses
    import shutil
    import torch.distributed as dist
    from leansdr_tpu_torch import device as kdev
    from leansdr_tpu_torch.dsp import filtergen, fir_kernel, receiver
    from leansdr_tpu_torch.parallel import group, halo, mesh, multihost
    from leansdr_tpu_torch.parallel import timeshard
    from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
    from leansdr_tpu_torch.util.ingest import DeviceFeeder
    t_path = time.perf_counter()
    work = kdev.BUILD / "multi"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counted = Launches()
    res = {}

    # 1. NCCL, one rank.
    rx = fleet_rx(dev, "1/2", exact=True)
    params, tables = rx.params, rx.tables
    del rx
    ra = params.readahead
    x = fleet_stimulus(dev, gen, CHUNK_SAMPLES + ra) * 75.0
    xh = torch.randn((2, MULTI_HALO), device=dev, generator=gen)
    taps = filtergen.root_raised_cosine(32, 0.25, 0.35).astype(np.float32)
    taps_d = torch.from_numpy(taps).to(dev)
    st0 = receiver.init_state(params, NCHAN, dev)
    step = mesh.sharded_demod_step(params)
    sfir = halo.sharded_fir(taps)
    group.init(0, 1, f"tcp://127.0.0.1:{multihost.free_port()}", "nccl")
    try:
        torch.cuda.synchronize()
        counted.zero()
        st_s, out_s, mer = step(tables, mesh.shard_channels(st0),
                                mesh.shard_channels(x))
        y_s = sfir(xh)
        torch.cuda.synchronize()
        nccl = counted.read()
        backend = dist.get_backend()
        halo_ms = cuda_time(lambda: sfir(xh), 20)
    finally:
        dist.destroy_process_group()
    if nccl["scan_demod"] != 1 or nccl["fir"] != 1:
        fail(f"multi NCCL D=1 did not run through the kernels: {nccl}")
    st_u, out_u = receiver.run_chunks(params, tables, st0, x)
    _equal_trees("multi mesh (NCCL D=1)", st_u, st_s)
    _equal_trees("multi mesh (NCCL D=1)", out_u, out_s)
    mer_u = float(out_u["mer"].mean())
    if float(mer) != mer_u:
        fail(f"multi mesh: mean MER {float(mer)} != {mer_u}")
    y_u = fir_kernel.fir(xh, taps_d)
    y_ref = fir_kernel.fir_ref(xh, taps_d)
    if not (torch.equal(y_s, y_u) and torch.equal(y_u, y_ref)):
        fail("multi halo (NCCL D=1): the sharded FIR != fir / fir_ref")
    # The halo's fir launch at its shape ([2, 2^24 + 32], the halo before
    # the block), beside one conv1d computing the same FIR (TF32 off) and
    # the plain version: device time per call from CUDA-graph replays in
    # turns, as fir_times does at the bench shape. Bound: each sample read
    # and written once; a multiply and an add per tap and output.
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    nt = len(taps)
    ext = torch.cat([xh.new_zeros((2, nt - 1)), xh], 1)
    xp = F.pad(ext, (nt - 1, 0))[:, None]
    wf = taps_d.flip(0).view(1, 1, -1)
    g = graph_ms({"conv1d": lambda: F.conv1d(xp, wf),
                  "fir": lambda: fir_kernel.fir(ext, taps_d)}, reps=20)
    fir_ms, lib_ms = (float(np.median(g[k])) for k in ("fir", "conv1d"))
    plain_ms = cuda_time(lambda: fir_kernel.fir_ref(ext, taps_d), 3)
    fir_bound = bound_ms(2 * ext.numel() * 4 + nt * 4,
                         2.0 * nt * ext.numel())
    del xp, ext
    print(f"[multi] {backend} D=1: sharded_demod_step over {NCHAN} x "
          f"{CHUNK_SAMPLES} (scan_demod, rrc exact) == run_chunks on every "
          f"output and state plane, mean MER {float(mer):.3f} dB; "
          f"sharded_fir over {MULTI_HALO} samples == fir == fir_ref; "
          f"launches {nccl}; the halo step {halo_ms:.4f} ms (CUDA "
          f"events), its fir launch {fir_ms:.4f} ms ([2, {MULTI_HALO} + "
          f"{nt - 1}], {nt} taps; graph replays "
          + " ".join(f"{t:.4f}" for t in g["fir"]) + f"), bound "
          f"{fir_bound[0]:.4f} ms by {fir_bound[1]}; conv1d {lib_ms:.4f} "
          f"ms; fir_ref {plain_ms:.3f} ms; {card}")

    # 2. Two gloo ranks on the card, and the multihost fleet beside them.
    B = MULTI_RING_BLOCK
    torch.save(dict(
        x=xh.cpu(), taps=torch.from_numpy(taps),
        params=dataclasses.asdict(params),
        tables={k: v.cpu() for k, v in tables.items()},
        state={k: v[:2].cpu() for k, v in st0.items()},
        ins=torch.from_numpy(timeshard.diagonal_layout(
            x[:2].cpu().numpy(), B, ra))), work / "multi_in.pt")
    t0 = time.perf_counter()
    ranks = [subprocess.Popen([sys.executable, __file__, "--multi-rank",
                               str(r), str(work)]) for r in (0, 1)]
    CHILDREN.extend(ranks)
    fleet = subprocess.Popen(
        [sys.executable, "-m", "leansdr_tpu_torch.parallel.multihost",
         "--world", "2", "--backend", "gloo", "--nchan", str(NCHAN),
         "--chunk", str(CHUNK_SAMPLES), "--windows", str(MULTI_WINDOWS),
         "--out", str(work / "ts"), "--timeout", str(MULTI_TIMEOUT_S)],
        stdout=subprocess.PIPE, text=True)
    CHILDREN.append(fleet)
    # The single-process fleet's stimulus on the host meanwhile: the same
    # carriers the ranks modulate.
    rxs = MultiDvbsReceiver(multihost.fleet_config(), NCHAN,
                            chunk_samples=CHUNK_SAMPLES, device=dev)
    nsamp = MULTI_WINDOWS * CHUNK_SAMPLES + rxs.readahead
    iq = np.stack([multihost.carrier_iq(c, nsamp) for c in range(NCHAN)])
    for p in ranks:
        if p.wait(timeout=MULTI_TIMEOUT_S) != 0:
            fail(f"multi: a gloo rank exited {p.returncode}")
    ranks_s = time.perf_counter() - t0
    got = [torch.load(work / f"multi_out{r}.pt") for r in (0, 1)]
    if not torch.equal(torch.cat([g["halo"] for g in got], 1),
                       y_u.cpu()):
        fail("multi halo (gloo D=2): != the unsharded fir")
    S = CHUNK_SAMPLES // B
    o = got[0]["outs"]
    for k, v in o.items():                 # [S, 2, ...] superstep-major
        u = torch.from_numpy(timeshard.undiagonal(v.numpy(), 2))
        u = u.reshape((2, -1) + tuple(v.shape[3:]))
        want = out_u[k][:2].cpu()
        if k in ("symbol", "valid", "cost"):
            want = want[:, :S * B]
        if not torch.equal(u, want):
            fail(f"multi ring (gloo D=2): {k} != the unsharded run_chunks")
    _equal_trees("multi ring (gloo D=2) end state",
                 {k: v[:2].cpu() for k, v in st_u.items()}, got[0]["state"])
    gloo = {k: sum(g["launches"][k] for g in got) for k in counted}
    if gloo["fir"] != 2 or gloo["scan_demod"] != 2 * S:
        fail(f"multi gloo ranks did not run through the kernels: {gloo}")
    print(f"[multi] {got[0]['backend']} D=2, both ranks on {card}: halo == "
          f"the unsharded fir; ring over 2 carriers in {S} supersteps of {B}"
          f" samples == run_chunks (symbols, valid, every output, end "
          f"state); launches {gloo}; {ranks_s:.1f} s with process start")
    so, _ = fleet.communicate(timeout=MULTI_TIMEOUT_S)
    fleet_s = time.perf_counter() - t0
    if fleet.returncode != 0:
        fail(f"multihost exited {fleet.returncode}: {so[-2000:]}")
    mh = [json.loads(l) for l in so.splitlines() if l.startswith("{")]
    mh_launches = {k: sum(r["launches"].get(k, 0) for r in mh)
                   for k in counted}
    if mh_launches["demod"] < 2 * MULTI_WINDOWS or mh_launches["acs"] < 2:
        fail(f"multihost did not run through the kernels: {mh_launches}")

    # 3. The single-process fleet through DeviceFeeder.
    torch.cuda.synchronize()
    counted.zero()
    ts = [[] for _ in range(NCHAN)]
    waits, marks = [], []
    it = iter(DeviceFeeder(multihost.windows(iq, CHUNK_SAMPLES,
                                             rxs.readahead, dev), device=dev))
    t0 = time.perf_counter()
    while True:
        tw = time.perf_counter()
        win = next(it, None)
        waits.append(time.perf_counter() - tw)
        if win is None:
            break
        for c, pk in enumerate(rxs.process(win)):
            ts[c].append(pk)
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single = counted.read()
    single_rate = NCHAN * MULTI_WINDOWS * CHUNK_SAMPLES / single_s / 1e6
    # After the first chunk (the rank's one-time set-up), as the ranks
    # report it.
    single_steady = (NCHAN * (MULTI_WINDOWS - 1) * CHUNK_SAMPLES
                     / (marks[-1] - marks[0]) / 1e6)
    if not all(rxs.locks):
        fail(f"multi single-process fleet: not locked: "
             f"{[c for c, l in enumerate(rxs.locks) if not l]}")
    total_good, worst = 0, 1.0
    for c in range(NCHAN):
        pk = np.concatenate(ts[c])
        n_after, n_good, span = check_packets(c, pk)
        worst = min(worst, n_good / max(n_after, 1), n_good / span)
        total_good += int(n_good)
        if n_good < 100 or n_good < 0.9 * n_after or n_good < 0.9 * span:
            fail(f"multi fleet channel {c}: {n_good} sent packets of "
                 f"{n_after} after lock, span {span}")
        if (work / "ts" / f"ch_{c}.ts").read_bytes() != pk.tobytes():
            fail(f"multihost carrier {c}: TS != the single-process fleet's")
    if any(r["fleet_ts_decoded"] != sum(len(np.concatenate(t)) for t in ts)
           for r in mh):
        fail("multihost: the reduced packet count != the single process's")
    print(f"[multi] multihost --world 2 --backend gloo: {NCHAN} carriers x "
          f"{MULTI_WINDOWS} chunks, {NCHAN // 2} per rank, TS == the "
          f"single-process fleet's on every carrier; {total_good} sent "
          f"packets after lock, worst fraction {worst:.4f}; ranks report "
          f"{mh[0]['fleet_ts_decoded']} decoded, "
          f"{mh[0]['fleet_ts_verified']} verified, "
          f"{mh[0]['fleet_aggregate_msamples_per_s']:.1f} Msamples/s "
          f"(elapsed {[round(r['rank_elapsed_s'], 3) for r in mh]} s; "
          f"after the first chunk "
          f"{mh[0]['fleet_steady_msamples_per_s']:.1f} Msamples/s), "
          f"the single-process fleet {single_rate:.1f} Msamples/s "
          f"({single_s:.3f} s, first chunk included; after it "
          f"{single_steady:.1f}), "
          f"stage 1 {mh[0]['fleet_symbols_sum']} symbols, MER "
          f"{mh[0]['fleet_mer_mean_db']:.2f} dB, FIR "
          f"{mh[0]['fir_msamples_per_s']:.1f} Msamples/s; launches "
          f"{mh_launches}; {fleet_s:.1f} s with process start")

    # 4. DeviceFeeder: contents and waits over MULTI_FEED chunks, the
    # host-to-device rate.
    shape = (NCHAN, CHUNK_SAMPLES + rxs.readahead, 2)
    base = (np.arange(np.prod(shape), dtype=np.int64) % 4093).astype(
        np.float32).reshape(shape)
    base_d = torch.from_numpy(base).to(dev)
    rxf = MultiDvbsReceiver(multihost.fleet_config(), NCHAN,
                            chunk_samples=CHUNK_SAMPLES, device=dev)
    feed_waits, bad = [], []
    it = iter(DeviceFeeder((base + np.float32(k) for k in range(MULTI_FEED)),
                           device=dev))
    for k in range(MULTI_FEED + 1):
        tw = time.perf_counter()
        t = next(it, None)
        feed_waits.append(time.perf_counter() - tw)
        if t is None:
            break
        if not torch.equal(t, base_d + k):
            bad.append(k)
        rxf.process(t)
    if bad or k != MULTI_FEED:
        fail(f"DeviceFeeder: chunks {bad} wrong, {k} of {MULTI_FEED} came")
    nbytes = base.nbytes
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    h2d = {"pinned": [], "pageable": []}
    for kind in ("pinned", "pageable", "pageable", "pinned"):
        src = pinned if kind == "pinned" else pageable
        h2d[kind].append(cuda_time(
            lambda: dst.copy_(src, non_blocking=True), MULTI_H2D_REPS))
    gbs = {k: nbytes / (sum(v) / len(v) / 1e3) / 1e9 for k, v in h2d.items()}
    wait_ms = [w * 1e3 for w in feed_waits[1:-1]]
    print(f"[multi] DeviceFeeder: {MULTI_FEED} chunks of {shape} float32 "
          f"({nbytes / 1e6:.1f} MB) each equal on the card; consumer's wait "
          f"per chunk while the fleet's process() runs: median "
          f"{np.median(wait_ms):.3f} ms, max {max(wait_ms):.3f} ms (first "
          f"{feed_waits[0] * 1e3:.1f} ms); the single-process fleet's "
          f"waits {[round(w * 1e3, 3) for w in waits]} ms; H2D "
          f"{gbs['pinned']:.2f} GB/s pinned, {gbs['pageable']:.2f} GB/s "
          f"pageable; {card}")
    path_s = time.perf_counter() - t_path
    print(f"[multi] path took {path_s:.1f} s")
    res.update(
        card=card, nccl_launches=nccl, gloo_launches=gloo,
        multihost_launches=mh_launches, single_launches=single,
        halo_ms=halo_ms, fir_ms=fir_ms, fir_bound=fir_bound,
        fir_graph_ms=g["fir"], fir_library_ms=lib_ms,
        fir_library_graph_ms=g["conv1d"], fir_plain_ms=plain_ms,
        fir_shape=f"R=2 n={MULTI_HALO + nt - 1} nt={nt} (the halo's launch)",
        single_msamples_per_s=single_rate,
        single_steady_msamples_per_s=single_steady,
        mean_mer_db=float(mer), ranks=mh, gloo_s=ranks_s, multihost_s=fleet_s,
        single_process_s=single_s, single_waits_ms=[w * 1e3 for w in waits],
        feed_wait_ms_median=float(np.median(wait_ms)),
        feed_wait_ms_max=float(max(wait_ms)),
        feed_first_wait_ms=feed_waits[0] * 1e3, h2d_gb_per_s=gbs,
        h2d_ms=h2d, chunk_bytes=nbytes, packets_good=total_good,
        worst=worst, seconds=path_s)
    return res


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


def kernel_times(rx, frames, dev, gen, chains, acs_chain_res):
    """Kernel times at the main paths' shapes. `chains`: demod_chain's
    (the table instance's chain bounds the launches that take the table,
    the other QPSK loop's the 8192-channel launch)."""
    from leansdr_tpu_torch.dsp import mf_prefilter, receiver_kernel as rk
    from leansdr_tpu_torch.fec import viterbi_device as vd
    chain = chains["table"]
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
    # A fleet wide enough to occupy every SM (8192 channels = 256 warps:
    # the layout without the table), one carrier over one of leandvb's
    # 2^17-sample reads, and the benchmark's 14-carrier fleet chunk.
    for key, Cw, nw in (("demod_wide", 8192, 1 << 15),
                        ("demod_one", 1, 1 << 17),
                        ("demod_14", 14, 1 << 18)):
        rows = torch.arange(Cw, device=dev) % C
        xw = xm[rows, :nw + 1].contiguous()
        pw = planes[:, rows].contiguous()
        ms = cuda_time(lambda: rk.demod(rx.params, rx._sym_consts, pw, xw),
                       reps=3)
        out[key] = dict(
            ms=ms, bound=bound_ms((nw + 1) * Cw * 8 + nw * Cw * 4,
                                  110.0 * nw * Cw),
            shape=f"C={Cw} nsamp={nw}",
            **chain_ms(nw, chains["no table" if Cw == 8192 else "table"],
                       clock))
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
                                   ("demod_one", 1 << 17),
                                   ("demod_14", 1 << 18)))
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
    issue, per B (1: 1/2, 2: 2/3, 3: 3/4, 4: 4/6 and 4/5, 5: 5/6, 7:
    7/8), from its built
    library's SASS: tools/sass_chain.py on the block loop (one barrier
    per block; the ring reduction, once per 64 blocks behind a branch,
    left out), the shared-memory exchange counted (exchange=True)."""
    sys.path.insert(0, str(TOOLS))
    import sass_chain
    text = sass_of(so)
    out = {}
    for B in (1, 2, 3, 4, 5, 7):
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
    ACQUIRE (64 x nsyncs lanes) and TRACK (64 lanes), at every QPSK fleet
    punctured rate and slice 8's fleets (8PSK's 4/6, BPSK's 1/2; CUDA
    events, 2 calls), and the single carrier's launches (its nsyncs
    lanes, T=128: hq 3/4, 8PSK 2/3, 32APSK 4/5; device time from
    CUDA-graph replays of 50 calls), with bounds at the INT32 issue rate
    (banked_ops), cycles per block and, beside them, the SASS chain and
    one warp's in-order issue per block (banked_chain)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    out = []
    shapes = []
    for rate, const in (("3/4", "QPSK"), ("7/8", "QPSK"), ("5/6", "QPSK"),
                        ("4/6", "QPSK"), ("4/6", "PSK8"), ("1/2", "BPSK")):
        plan = fleet_plan(rate, dev, const)
        tag = "" if const == "QPSK" else f" {const}"
        shapes += [(rate, "acquire" + tag, plan.n_lanes, plan.nblocks),
                   (rate, "track" + tag, NCHAN, plan.nblocks)]
    shapes += [("3/4", "hq", sc_lanes("3/4", dev), 128),
               ("2/3", "sc PSK8", sc_lanes("2/3", dev, "PSK8"), 128),
               ("4/5", "sc APSK32", sc_lanes("4/5", dev, "APSK32"), 128)]
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
        print(f"kernel acs_banked {rate} {mode:14s} N={N:4d} T={T}: "
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
                 if "registers" in l or "spill" in l
                 or (name in ("scan_demod", "hs_demod")
                     and "Compiling entry" in l)]
        print(f"  {name}: {so.name}: " + " | ".join(lines))

    clock = max_sm_clock_hz()
    lat, lat_int = latency_table(probe_build, dev)
    chains = demod_chain(built["demod"][0], lat, clock)
    chain = chains["table"]
    a_chain = acs_chain(built["acs"][0], lat_int, clock)
    b_chain = banked_chain(built["acs_banked"][0], lat_int, clock)
    s_chain = scan_chain(built, lat, clock)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    check_sincos(dev)
    check_pe_table(dev)
    d_err = 0.0
    d_plain = None
    for predef, rate, nsym, C, n in DEMOD_CHECKS:
        e, p = check_demod(predef, rate, nsym, C, n, dev, gen)
        d_err = max(d_err, e)
        if d_plain is None:
            d_plain = p
    gen_pe = torch.Generator(device=dev)
    gen_pe.manual_seed(SEED_PE)
    d_err = max(d_err, check_demod_off_grid(dev, gen_pe)[0])
    d_long = check_demod_long(dev, gen_pe)
    s_err, s_plain = check_scan_demod(dev, gen)
    a_err, a_plain = check_acs(dev, gen)
    long_acs = start_long_acs(dev, gen)
    b_err, b_plain, b_plain_n = check_acs_banked(dev, gen)
    long_banked = [start_long_banked(dev, gen, r) for r in PUNCTURED]
    f_err, f_plain_c, f_plain_r = check_fir(dev, gen)

    fft_err, fft_rel_plain, fft_rel_lib = check_fft(dev, gen)
    fft = fft_times(dev)
    check_first_argmax(dev, gen)
    check_first_argmin(dev)
    # Slice 8's kernel checks and fleet paths, from their own generator.
    gen8 = torch.Generator(device=dev)
    gen8.manual_seed(SEED_8)
    s8_err, s8_plain = check_slice8(dev, gen8)
    # Slice 9's kernel check (scan_demod's per-channel omega), from its own
    # generator, which its FM stimulus then draws from.
    gen9 = torch.Generator(device=dev)
    gen9.manual_seed(SEED_9)
    pc_err, pc_plain = check_scan_per_channel(dev, gen9)

    # Phase 4: the fleet at each rate, sequential (segments=1) and
    # segmented (segments=8), on one stimulus per rate; at rate 1/2 also
    # the segment sweep and the segmented launches against demod_ref.
    frames = fleet_frames(dev, gen, "1/2")
    acq_rel = check_acq_fft(dev, frames)
    rx, run, piped_rate = main_path(dev, gen, frames)
    launches, stages, rate = run["launches"], run["stages"], run["rate"]
    times = kernel_times(rx, frames, dev, gen, chains, a_chain)
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
    # The hard-decision fleet (viterbi=False) on the same stimulus, and
    # the fleet CLI on its first CLI_CHUNKS chunks.
    hard = {"1/2": hard_path(dev, frames, "1/2"),
            "1/2 S=8": hard_path(dev, frames, "1/2", S=8),
            "1/2 linear": hard_path(dev, frames, "1/2", sampler="linear")}
    # The scan demod's exact route (polyphase rrc) on the same stimulus.
    exact = {"1/2": exact_fleet_path(dev, frames),
             "1/2 S=8": exact_fleet_path(dev, frames, S=8),
             "1/2 hard": exact_fleet_path(dev, frames, viterbi=False)}
    stimes = scan_times(dev, frames, s_chain, clock)
    cli = cli_path(dev, frames)
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
        hard[code_rate] = hard_path(dev, frames, code_rate)
        del frames
    # Slice 8: the fleet at 8PSK 2/3 (as 4/6) and BPSK 1/2, and the fleet's
    # preprocessing (anf, cnr, spectrum).
    fleet8 = {p[0]: fleet8_path(dev, gen8, *p) for p in FLEET_PATHS_8}
    btimes = banked_times(dev, gen, b_chain, clock)
    b0 = btimes[0]                      # 3/4 ACQUIRE: the headline shape
    for job in [long_acs] + long_banked:  # before the host-timed streams
        finish_plain(job)
    rng = np.random.default_rng(SEED)
    stimuli = {}
    single = [single_carrier(dev, rng, stimuli, *p) for p in SC_PATHS]
    # Slice 7: the canonical pipe from the port's CLIs, --awgn, --hdlc.
    pipe = pipe_path(dev)
    awgn_off, awgn = awgn_path(dev, rng, stimuli)
    hdlc = hdlc_path(dev, rng)
    del stimuli
    # Slice 8's single-carrier paths, from their own seed.
    rng8 = np.random.default_rng(SEED_8)
    single8 = [single_carrier(dev, rng8, {}, *p[:-1], twin=p[-1])
               for p in SC_PATHS_8]
    item24 = brickwall(dev)
    ftimes = fir_times(dev, gen)
    # Slice 9: the device modulator, the candidate scan (in process and
    # leansdrscan --device), the FM receiver (leanmlmrx), from SEED_9.
    tx = tx_path(dev)
    scan9 = scan_path(dev, np.random.default_rng(SEED_9), s_chain, clock)
    fm = fm_path(dev, gen9)
    # Slice 10: the parallel modules (NCCL at one rank, two gloo ranks on
    # the card, the multihost fleet) and DeviceFeeder, from SEED_10.
    gen10 = torch.Generator(device=dev)
    gen10.manual_seed(SEED_10)
    multi = multi_path(dev, gen10, card)
    # Each path's own count (zeroed just before it, read just after).
    by_path = {"fleet 1/2": launches}
    by_path.update({f"fleet {r}": p["launches"] for r, p in punctured.items()})
    by_path.update({f"fleet {r} S=8": p["launches"] for r, p in seg.items()})
    by_path.update({f"hard fleet {r}": p["launches"] for r, p in hard.items()})
    by_path.update({f"exact fleet {r}": p["launches"]
                    for r, p in exact.items()})
    by_path.update({name: r["launches"] for name, r in fleet8.items()})
    by_path["leandvbfleet --acq"] = cli["launches"]
    by_path.update({r["path"]: r["launches"]
                    for r in single + [awgn_off, awgn, hdlc] + single8})
    by_path["pipe (leandvb child)"] = pipe["launches"]
    by_path["scan (CandidateScanReceiver)"] = scan9["launches"]
    by_path["leansdrscan --device (child)"] = scan9["cli"]["launches"]
    by_path["multi: NCCL D=1 (mesh, halo)"] = multi["nccl_launches"]
    by_path["multi: 2 gloo ranks (halo, ring)"] = multi["gloo_launches"]
    by_path["multi: multihost 2 gloo ranks"] = multi["multihost_launches"]
    by_path["multi: single-process fleet (DeviceFeeder)"] = \
        multi["single_launches"]
    print("demod launches on the phase-error table: " + ", ".join(
        f"{p} {c.get(DEMOD_PE, '-')} of {c['demod']}"
        for p, c in by_path.items() if c.get("demod")))
    for p in ("fleet 1/2", "canonical"):   # the benchmark's two paths
        c = by_path[p]
        if c["demod"] < 1 or c[DEMOD_PE] != c["demod"]:
            fail(f"{p}: {c[DEMOD_PE]} of {c['demod']} demod launches on "
                 f"the phase-error table")
    halo_fir = (multi["nccl_launches"]["fir"]
                + multi["gloo_launches"]["fir"])
    resample = next(r for r in single if r["path"] == "resample")
    hs_run = next(r for r in single if r["path"] == "hs")

    kernels = [
        {"name": "demod", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/demod.cu",
         "replaces": "leansdr_tpu/dsp/receiver_pallas.py:61",
         "launches": launches["demod"], "max_abs_err": max(d_err, s8_err),
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
         "chain_path_mix": chain["path_mix"],
         "no_table": {k: chains["no table"][k] for k in (
             "cycles_per_step", "issue_cycles_per_step",
             "path_instructions_per_step", "instructions_per_step")},
         "latency_cycles": lat,
         "wide_ms": times["demod_wide"]["ms"],
         "wide_shape": times["demod_wide"]["shape"],
         "one_ms": times["demod_one"]["ms"],
         "one_shape": times["demod_one"]["shape"],
         "fleet14_ms": times["demod_14"]["ms"],
         "fleet14_shape": times["demod_14"]["shape"],
         "long_plain_ms": d_long,
         "segmented_shapes": seg_times,
         "segmented_plain": [dict(lanes=c, nsamp=SC_DEMOD_CHECK, plain_ms=ms)
                             for c, ms in seg_checks],
         "plain_shape": f"C={NCHAN} nsamp=4096"},
        {"name": "acs", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/acs.cu",
         "replaces": "leansdr_tpu/fec/viterbi_device.py:91",
         "launches": launches["acs"], "max_abs_err": max(a_err, s8_err),
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
         "max_abs_err": max(b_err, s8_err), "ms": b0["ms"],
         "plain_ms": b_plain,
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
         "launches": halo_fir,
         "launches_path": "multi: halo.sharded_fir, NCCL D=1 and 2 gloo "
                          "ranks (its first runtime path)",
         "max_abs_err": f_err,
         "ms": multi["fir_ms"], "plain_ms": multi["fir_plain_ms"],
         "bound_ms": multi["fir_bound"][0],
         "bound_by": multi["fir_bound"][1],
         "library_ms": multi["fir_library_ms"],
         "shape": multi["fir_shape"],
         "timing": "device time per call from CUDA-graph replays of 20 "
                   "calls, in turns with conv1d, median of 3 rounds",
         "graph_ms": multi["fir_graph_ms"],
         "library_graph_ms": multi["fir_library_graph_ms"],
         "plain_shape": multi["fir_shape"],
         "bench_shape": {
             "shape": ftimes["fir"]["shape"], "ms": ftimes["fir"]["ms"],
             "bound_ms": ftimes["fir"]["bound"][0],
             "library_ms": ftimes["fir"]["library_ms"],
             "graph_ms": ftimes["fir"]["graph_ms"],
             "library_graph_ms": ftimes["fir"]["library_graph_ms"],
             "host_paced_ms": ftimes["fir"]["host_paced_ms"],
             "library_host_paced_ms":
                 ftimes["fir"]["library_host_paced_ms"],
             "fp32_issue_floor_ms": ftimes["fir"]["fp32_issue_floor_ms"],
             "plain_ms": f_plain_r, "plain_shape": "R=128 n=131157 nt=79"}},
        {"name": "fft4096", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/fft4096.cu",
         "replaces": "leansdr_tpu/dsp/fft_pallas.py:58",
         "launches": cli["launches"]["fft4096"],
         "launches_path": "leandvbfleet --acq (its only runtime path)",
         "max_abs_err": fft_err, "rel_err_acq_shape": acq_rel,
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
        {"name": "scan_demod", "route": "cuda",
         # launches_by_path: the static-omega launches (the per-channel
         # mode's are in its own row).
         "counter": lambda c: c["scan_demod"] - c[SCAN_PC],
         "source": "leansdr_tpu_torch/csrc/scan_demod.cu",
         "replaces": "leansdr_tpu/dsp/receiver.py:177 (run_chunks_impl, a "
                     "lax.scan: no Pallas kernel)",
         "launches": exact["1/2"]["launches"]["scan_demod"],
         "launches_path": "exact fleet 1/2",
         "max_abs_err": s_err, "ms": stimes["fleet"]["ms"],
         "plain_ms": s_plain[("rrc", True, NCHAN)],
         "plain_shape": f"C={NCHAN} nsamp={SCAN_CHUNKS * 128} rrc exact",
         "bound_ms": stimes["fleet"]["bound"][0],
         "bound_by": stimes["fleet"]["bound"][1], "library_ms": None,
         "shape": stimes["fleet"]["shape"],
         "chain_bound_ms": stimes["fleet"]["chain_bound_ms"],
         "chain_source": "tools/sass_chain.py --hot-loads on cuobjdump "
                         "-sass of the built scan_demod, per emitted "
                         "symbol, latencies from tools/latency_probe.cu on "
                         "this card (gathers at its L1 and L2 hits)",
         "chain_cycles_per_symbol": {k: r["cycles_per_step"]
                                     for k, r in s_chain.items()
                                     if k != "hs"},
         "chain_cycles_per_symbol_l2": {k: r["cycles_per_step_l2"]
                                        for k, r in s_chain.items()
                                        if k != "hs"},
         "shapes": {k: {f: v[f] for f in (
             "ms", "chain_bound_ms", "chain_bound_ms_l2", "cycles_per_step",
             "shape")} | {"bound_ms": v["bound"][0]}
             for k, v in stimes.items() if not k.startswith("hs")},
         "plain_ms_by_case": {str(k): v for k, v in s_plain.items()
                              if k[0] != "hs"}},
        {"name": "hs_demod", "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/hs_demod.cu",
         "replaces": "leansdr_tpu/dsp/receiver_hs.py:102 (run_chunks_hs, "
                     "a lax.scan: no Pallas kernel)",
         "launches": hs_run["launches"]["hs_demod"],
         "launches_path": "hs (single carrier)",
         "max_abs_err": s_err, "ms": stimes["hs 1.2"]["ms"],
         "plain_ms": s_plain[("hs", 1.2, NCHAN)],
         "plain_shape": f"C={NCHAN} nsamp={SCAN_CHUNKS * 128} omega 1.2",
         "bound_ms": stimes["hs 1.2"]["bound"][0],
         "bound_by": stimes["hs 1.2"]["bound"][1], "library_ms": None,
         "shape": stimes["hs 1.2"]["shape"],
         "chain_bound_ms": stimes["hs 1.2"]["chain_bound_ms"],
         "chain_cycles_per_sample": s_chain["hs"]["cycles_per_step"],
         "cycles_per_sample": stimes["hs 1.2"]["cycles_per_step"],
         "omega_2": {f: stimes["hs"][f] for f in (
             "ms", "chain_bound_ms", "cycles_per_step", "shape")}},
        {"name": SCAN_PC, "route": "cuda",
         "source": "leansdr_tpu_torch/csrc/scan_demod.cu",
         "replaces": "leansdr_tpu/dsp/receiver.py:177 (run_chunks_impl "
                     "with omega_per_channel, :204-213, :400-402; a "
                     "lax.scan: no Pallas kernel)",
         "launches": scan9["launches"][SCAN_PC],
         "launches_path": "scan (CandidateScanReceiver, 4 SR x 5 CR)",
         "max_abs_err": max(pc_err, scan9["kernel"]["err"]),
         "ms": scan9["kernel"]["ms"],
         "plain_ms": pc_plain[("linear", False, 4)],
         "plain_shape": f"C=4 nsamp={SCAN_CHUNKS * 128} linear computed",
         "plain_ms_by_case": {str(k): v for k, v in pc_plain.items()},
         "plain_ms_scan_launches": scan9["kernel"]["plain"],
         "bound_ms": scan9["kernel"]["bound"][0],
         "bound_by": scan9["kernel"]["bound"][1], "library_ms": None,
         "shape": scan9["kernel"]["shape"],
         "chain_bound_ms": scan9["kernel"]["chain_bound_ms"],
         "chain_bound_ms_l2": scan9["kernel"]["chain_bound_ms_l2"],
         "emitted": scan9["kernel"]["emitted"],
         "focused": scan9["kernel"]["focused"]},
    ]
    for k in kernels:
        count = k.pop("counter", lambda c, name=k["name"]: c[name])
        k["launches_by_path"] = {p: count(c) for p, c in by_path.items()}
    hard_out = {r: dict(launches=p["launches"], stages_ms=p["stages"],
                        chain_msamples_per_s=p["rate"],
                        chunk_ms=p["chunk_ms"], demod_checked=p["checked"],
                        decode_ms=p["decode_ms"],
                        decode_peak_mb=p["decode_peak_mb"])
                for r, p in hard.items()}
    exact_out = {r: dict(launches=p["launches"], stages_ms=p["stages"],
                         chain_msamples_per_s=p["rate"],
                         chunk_ms=p["chunk_ms"], scan_checked=p["checked"],
                         mer_db=p["mer_db"])
                 for r, p in exact.items()}
    print(json.dumps({"stages_ms": stages, "chain_msamples_per_s": rate,
                      "pipelined_msamples_per_s": piped_rate,
                      "punctured": punctured, "segmented": seg,
                      "segment_sweep": sweep, "hard": hard_out,
                      "exact_fleet": exact_out, "leandvbfleet": cli,
                      "single_carrier": single, "item24_brickwall": item24,
                      "pipe": pipe, "awgn": awgn, "awgn_off": awgn_off,
                      "hdlc": hdlc, "fleet_slice8": fleet8,
                      "single_carrier_slice8": single8,
                      "slice8_checks_plain_ms": s8_plain,
                      "tx": tx, "scan": scan9, "fm": fm, "multi": multi,
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
    if sys.argv[1:2] == ["--multi-rank"]:    # multi_path's gloo ranks
        multi_rank_job(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
