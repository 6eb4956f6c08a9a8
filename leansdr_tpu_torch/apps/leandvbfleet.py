"""Multi-carrier DVB-S fleet receiver CLI (the counterpart of
leansdr_tpu/apps/leandvbfleet.py), on the port's MultiDvbsReceiver: N
independent carriers demodulated in one device batch (the demod kernel,
the device hard decode or Viterbi) with the byte domain in the C++
backend, software-pipelined through submit()/flush().

Usage: python -m leansdr_tpu_torch.apps.leandvbfleet --nchan N [options]
       < IQ > MUX

Input (stdin): sample-interleaved IQ, each frame nchan * (I, Q) in the
selected format (the layout of a channelizer or of N tuners read in
lockstep), read `--chunk` frames at a time.

Output (stdout): a tagged multiplex, per completed chunk and channel
with packets: [u32 chan][u32 npkts][npkts * 188 bytes] (little-endian
header); or per-channel files with --out-template 'out_%03d.ts'.

Flags shared with leandvb keep its names and semantics (_dvbs_flags).
The receiver runs on the GPU; `--device cpu` runs the kernels' plain
PyTorch versions. Decisions are computed on the demod kernel
(--no-exact-lut, the default) unless --exact-lut takes the scan demod's
256x256 LUT (with --sampler rrc its polyphase fir_sampler); --sampler
nearest also runs on the scan demod. Every constellation (--const) and
code rate the JAX CLI takes runs; a combination it refuses raises the
same ValueError before any input is read.
"""

import os
import struct
import sys
import time

import numpy as np


def usage(code=0, f=sys.stderr):
    f.write(
        "Usage: leandvbfleet --nchan N [options]  < IQ  > MUX\n"
        "Demodulate N sample-interleaved DVB-S carriers in one device "
        "batch\n"
        "\nInput: --u8|--s8|--u16|--s16|--f32 (default f32), "
        "--float-scale F, -f FREQ\n"
        "       --chunk N  frames per read (default 65536)\n"
        "DVB-S: --sr HZ --cr N/D --sampler linear|nearest|rrc --viterbi "
        "--hq --fastlock\n"
        "       --exact-lut/--no-exact-lut --const C --tune FREQ --drift\n"
        "       (C: QPSK, BPSK, 8PSK, 16APSK, 32APSK, 64APSKe, 16QAM,\n"
        "       64QAM, 256QAM; N/D: 1/2, 2/3, 3/4, 4/6, 5/6, 7/8, 4/5)\n"
        "       --acq   per-channel FFT coarse carrier search on the\n"
        "               first chunk; each channel is derotated by its\n"
        "               estimate (not in the reference)\n"
        "       --segments S   time-segmented demod: split each chunk\n"
        "               into S lane-parallel segments\n"
        "Output: --out-template PATTERN   per-channel files (printf-style"
        " %d)\n"
        "        (default: tagged multiplex [u32 chan][u32 npkts][TS] on"
        " stdout)\n"
        "Info:   --fd-info FD   fleet lock/MER/VBER lines (tagged text)\n"
        "Port:   --device DEV   cuda (default) or cpu (plain PyTorch\n"
        "                       versions of the kernels)\n"
        "        --trace FILE   spans and counters of every chunk, as\n"
        "                       Chrome-trace JSON at exit\n")
    sys.exit(code)


def parse_args(argv):
    from ..pipelines.dvbs_rx import RxConfig
    from ._dvbs_flags import handle_dvbs_flag

    # The computed decisions of the demod kernel, which the JAX CLI
    # resolves to on an accelerator.
    cfg = RxConfig(exact_lut=False)
    opts = {"input": "f32", "nchan": 0, "out_template": None,
            "fd_info": -1, "chunk": 1 << 16, "acq": False, "device": None}
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            usage(0, sys.stdout)
        elif a == "--nchan":
            opts["nchan"] = int(val())
        elif a == "--chunk":
            opts["chunk"] = int(val())
        elif a == "--out-template":
            opts["out_template"] = val()
        elif a == "--fd-info":
            opts["fd_info"] = int(val())
        elif a == "--acq":
            opts["acq"] = True
        elif a in ("--u8", "--s8", "--u16", "--s16", "--f32"):
            opts["input"] = a[2:]
        elif a == "--device":
            opts["device"] = val()
        elif handle_dvbs_flag(a, val, cfg):
            pass
        else:
            sys.stderr.write(f"leandvbfleet: unknown option {a}\n")
            usage(1)
        i += 1
    if opts["nchan"] <= 0:
        sys.stderr.write("leandvbfleet: --nchan is required\n")
        usage(1)
    return cfg, opts


_ITEMSIZE = {"u8": 1, "s8": 1, "u16": 2, "s16": 2, "f32": 4}


def _acquire(rx, iq):
    """Per-channel FFT coarse carrier search (dsp/acquisition.py) on the
    first chunk [C, n, 2]: a Rotator that derotates each channel by its
    estimate (None where |estimate| <= 1e-4 cycles/sample), which
    re-centres every carrier in the shared PLL clamp window."""
    from ..dsp.acquisition import coarse_carrier_estimate
    from ..dsp.blocks import Rotator
    m = rx.cstln.nsymbols
    m = m if m in (2, 4, 8) else 4
    derots = []
    for c in range(rx.nchan):
        est = coarse_carrier_estimate(iq[c], msymbols=m, device=rx.device)
        derots.append(Rotator(-est) if abs(est) > 1e-4 else None)
    return derots


def main(argv=None):
    cfg, opts = parse_args(sys.argv[1:] if argv is None else argv)
    from ..pipelines import multi_rx
    from ..util.info import InfoWriter
    from ..util.iofmt import read_iq
    from ._dvbs_flags import write_trace

    nchan = opts["nchan"]
    # Invalid settings raise here, before any device or input is used.
    rx = multi_rx.MultiDvbsReceiver(
        cfg, nchan, chunk_samples=opts["chunk"], segments=cfg.segments,
        seg_warmup=cfg.seg_warmup, seg_holdoff=cfg.seg_holdoff,
        device=opts["device"])
    frame_bytes = nchan * 2 * _ITEMSIZE[opts["input"]]
    read_frames = opts["chunk"]

    info = None
    if opts["fd_info"] >= 0:
        info = InfoWriter(os.fdopen(opts["fd_info"], "w", buffering=1))

    outs = None
    mux = None
    if opts["out_template"]:
        outs = [open(opts["out_template"] % c, "wb")
                for c in range(nchan)]
    else:
        mux = sys.stdout.buffer

    def emit(batches):
        """batches: list of per-channel packet-array lists."""
        for per_chan in batches:
            for c, pkts in enumerate(per_chan):
                if not len(pkts):
                    continue
                if outs is not None:
                    outs[c].write(pkts.tobytes())
                else:
                    mux.write(struct.pack("<II", c, len(pkts)))
                    mux.write(pkts.tobytes())
        if mux is not None:
            mux.flush()

    src = sys.stdin.buffer
    derots = None
    next_info = 0.0
    try:
        while True:
            raw = src.read(read_frames * frame_bytes)
            n = len(raw) // frame_bytes
            if n == 0:
                break
            iq = np.ascontiguousarray(read_iq(
                raw[:n * frame_bytes], opts["input"]).reshape(
                    n, nchan, 2).transpose(1, 0, 2))
            if opts["acq"] and derots is None:
                derots = _acquire(rx, iq)
            for c, rot in enumerate(derots or ()):
                if rot is not None:
                    z = rot.process(iq[c, :, 0] + 1j * iq[c, :, 1])
                    iq[c, :, 0] = z.real
                    iq[c, :, 1] = z.imag
            emit(rx.submit(iq))
            # Info at ~1 Hz: metrics() copies device state and would
            # otherwise serialize the submit() pipeline every chunk.
            if info and time.monotonic() >= next_info:
                next_info = time.monotonic() + 1.0
                info.f.write(f"FLEETLOCKS {int(np.sum(rx.locks))}\n")
                m = rx.metrics()
                info.f.write(f"FLEETMER {m['mer_db'].min():.1f} "
                             f"{m['mer_db'].mean():.1f}\n")
                vb = int(np.sum(rx.vbitcount))
                if vb:
                    info.f.write(f"FLEETVBER "
                                 f"{float(np.sum(rx.verrcount)) / vb:.6f}\n")
                info.flush()
        emit(rx.flush())
    finally:
        rx.close()
        for f in outs or ():
            f.close()
    write_trace()
    return 0


if __name__ == "__main__":
    sys.exit(main())
