"""leandvb-compatible DVB-S receiver CLI (reference leandvb.cc:974-1221),
on the port's single-carrier receiver (the counterpart of
leansdr_tpu/apps/leandvb.py).

Usage: python -m leansdr_tpu_torch.apps.leandvb [options] < IQ > TS

Flags mirror the reference and the JAX CLI 1:1; stdin is read in the
same 2^17-sample blocks and stdout carries the same TS. The receiver
runs on the GPU; `--device cpu` runs the kernels' plain PyTorch
versions instead, for tests and CPU drives.
Decisions are computed (--no-exact-lut, the default: the demod kernel)
unless --exact-lut or --hard-metric take the scan demod's 256x256 LUT;
--sampler nearest also runs on the scan demod, and --hs on the integer
fast-QPSK demod. --awgn adds the drand48 noise stream before the
preprocessing; --cnr writes CNR lines on the --fd-info stream and
--fd-spectrum FD SPECTRUM lines on FD; --hdlc writes HDLC frames instead
of TS. Every constellation and code rate the JAX CLI takes runs; a
combination it refuses raises the same ValueError.
"""

import sys

import numpy as np


def usage(code=0, f=sys.stderr):
    f.write(
        "Usage: leandvb [options]  < IQ  > TS\n"
        "Demodulate DVB-S I/Q on stdin, output MPEG packets on stdout\n"
        "\nInput options:\n"
        "  --u8, --s8, --u16, --s16, --f32   Input format (default u8)\n"
        "  --float-scale FLOAT     Scaling factor for float data\n"
        "  -f FREQ                 Sampling rate (Hz)\n"
        "  --loop                  Repeat input file forever\n"
        "\nPreprocessing options:\n"
        "  --awgn STDDEV           Add white gaussian noise\n"
        "  --anf INT               Number of birdies to remove (default 1)\n"
        "  --derotate FREQ         Shift frequency (Hz)\n"
        "  --resample              Lowpass and decimate to ~4 sps\n"
        "  --resample-rej FLOAT    Lowpass rejection (default 10)\n"
        "  --decim INT             Decimate by INT\n"
        "  --cnr                   Measure CNR\n"
        "\nDVB-S options:\n"
        "  --sr SYMBOLRATE         Symbol rate (Hz, default 2e6)\n"
        "  --tune FREQ             Bias frequency for acquisition (Hz)\n"
        "  --drift                 Follow carrier beyond safe limits\n"
        "  --standard S            DVB-S (default)\n"
        "  --const C               Constellation (QPSK, BPSK, 8PSK, "
        "16APSK,\n"
        "                          32APSK, 64APSKe, 16QAM, 64QAM, 256QAM)\n"
        "  --cr N/D                Code rate: 1/2 (default), 2/3, 3/4, "
        "4/6,\n"
        "                          5/6, 7/8, 4/5\n"
        "  --sampler S             linear (default), nearest, rrc\n"
        "  --segments S            Time-segmented demod over S lanes\n"
        "  --rrc-rej FLOAT         RRC filter rejection (default 30)\n"
        "  --roll-off FLOAT        RRC roll-off (default 0.35)\n"
        "  --no-exact-lut          Computed decisions, the demod kernel "
        "(default)\n"
        "  --exact-lut             The reference's 256x256 LUT and trig16\n"
        "                          table (the scan demod)\n"
        "  --hard-metric           Hard decisions for Viterbi (implies\n"
        "                          --exact-lut)\n"
        "  --hs                    Integer fast-QPSK receiver (u8 input)\n"
        "  --hdlc                  ETR192-descrambled HDLC frames on\n"
        "                          stdout instead of TS\n"
        "  --packetized            With --hdlc: a 16-bit length before\n"
        "                          each frame\n"
        "  --fastlock              Synchronize more aggressively\n"
        "  --acq                   FFT coarse carrier search on the\n"
        "                          first chunk seeds --tune (not in the\n"
        "                          reference)\n"
        "  --viterbi               Use Viterbi decoding\n"
        "  --hq                    --fastlock --viterbi --sampler rrc\n"
        "\nUI options:\n"
        "  --fd-info FDNUM         Info messages to file descriptor\n"
        "  --fd-const FDNUM        Constellation to file descriptor\n"
        "  --fd-spectrum FDNUM     Spectrum to file descriptor\n"
        "  --fd-pp FDNUM           Dump preprocessed IQ data to fd\n"
        "  --duration FLOAT        Width of timeline plot (s) [no-op]\n"
        "  --json                  JSON format for aux outputs\n"
        "  --version               Display version and exit\n"
        "  -v, -d                  Verbose / debug\n"
        "\nPort options:\n"
        "  --device DEV            cuda (default) or cpu (plain PyTorch\n"
        "                          versions of the kernels)\n"
        "  --trace FILE            Spans and counters of every read, as\n"
        "                          Chrome-trace JSON at exit\n")
    sys.exit(code)


def parse_args(argv):
    from ..pipelines.dvbs_rx import RxConfig
    from ._dvbs_flags import handle_dvbs_flag

    # leandvb default anf=1 (leandvb.cc:103); the computed decisions of
    # the demod kernel, which the JAX CLI resolves to on an accelerator.
    cfg = RxConfig(anf=1, exact_lut=False)
    opts = {
        "input": "u8", "loop": False, "fd_info": -1, "fd_const": -1,
        "fd_spectrum": -1, "json": False, "verbose": False, "debug": False,
        "hs": False, "hdlc": False, "packetized": False, "buf_factor": 4,
        "Finfo": 5.0, "standard": "DVB-S", "acq": False, "debug2": False,
        "device": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            usage(0, sys.stdout)
        elif a == "--version":
            from .. import __version__
            print(f"leansdr-tpu-torch-{__version__}")
            sys.exit(0)
        elif a == "-v":
            opts["verbose"] = True
        elif a == "-d":
            # Second -d promotes to debug2 (leandvb.cc:1068-1071).
            opts["debug2"] = opts["debug"]
            opts["debug"] = True
            cfg.debug = True
        elif a == "--u8":
            opts["input"] = "u8"
        elif a in ("--s8", "--char"):
            opts["input"] = "s8"
        elif a == "--u16":
            opts["input"] = "u16"
        elif a == "--s16":
            opts["input"] = "s16"
        elif a == "--f32":
            opts["input"] = "f32"
        elif a == "--derotate":
            cfg.Fderot = float(val())
        elif a == "--loop":
            opts["loop"] = True
        elif a == "--awgn":
            cfg.awgn = float(val())
        elif a == "--anf":
            cfg.anf = int(val())
        elif a == "--cnr":
            cfg.cnr = True
        elif a == "--resample":
            cfg.resample = True
        elif a == "--resample-rej":
            cfg.resample_rej = float(val())
        elif a == "--decim":
            cfg.decim = int(val())
        elif a == "--standard":
            opts["standard"] = val()
        elif a == "--hard-metric":
            cfg.hard_metric = True
        elif a == "--hs":
            opts["hs"] = True
        elif a == "--hdlc":
            opts["hdlc"] = True
        elif a == "--packetized":
            opts["packetized"] = True
        elif a == "--fd-info":
            opts["fd_info"] = int(val())
        elif a == "--fd-const":
            opts["fd_const"] = int(val())
        elif a == "--fd-spectrum":
            opts["fd_spectrum"] = int(val())
        elif a == "--fd-pp":
            cfg.fd_pp = int(val())
        elif a == "--duration":
            val()       # GUI timeline width: accepted, no effect
        elif a == "--json":
            opts["json"] = True
        elif a == "--buf-factor":
            opts["buf_factor"] = int(val())
        elif a == "--inpipe" or a == "--inbuf":
            val()       # accepted, no-op (host buffering is adaptive)
        elif a == "--acq":
            opts["acq"] = True
        elif a == "--gui" or a == "--linger" or a == "--filler":
            pass        # GUI replaced by the fd-info/const streams
        elif a == "--nhelpers":
            val()
        elif a == "--device":
            opts["device"] = val()
        elif handle_dvbs_flag(a, val, cfg):
            pass        # shared DVB-S flags (_dvbs_flags.py)
        else:
            usage(1)
        i += 1
    if opts["fd_spectrum"] >= 0:
        cfg.want_spectrum = True
    if opts["hs"]:
        if opts["input"] != "u8":
            print("** --hs requires u8 input (fast_qpsk_receiver is "
                  "a u8 pipeline, sdr.h:946)", file=sys.stderr)
            sys.exit(1)
        cfg.hs = True
        cfg.anf = 0
    if opts["fd_const"] >= 0:
        cfg.want_const = True
    if opts["hdlc"]:
        cfg.hdlc = True
        cfg.packetized = opts["packetized"]
    return cfg, opts


def main(argv=None):
    from ..fec.convenc import FEC_SPECS
    from ..pipelines.dvbs_rx import DvbsReceiver
    from ..util import info as info_mod
    from ..util.iofmt import read_iq
    from ._dvbs_flags import write_trace

    cfg, opts = parse_args(sys.argv[1:] if argv is None else argv)
    rx = DvbsReceiver(cfg, device=opts["device"])

    if opts["debug"]:
        # Glyph legend (leandvb.cc:700-713).
        if not cfg.hdlc:
            sys.stderr.write(
                "Output:\n"
                "  '_': packet received without errors\n"
                "  '.': error-corrected packet\n"
                "  '!': packet with remaining errors\n")
        else:
            sys.stderr.write(
                "Output:\n"
                "  '_': HDLC frame with correct checksum\n"
                "  '!': HDLC frame with invalid checksum\n"
                "  '^': HDLC framing error\n")

    info = None
    if opts["fd_info"] >= 0:
        info = info_mod.InfoWriter(opts["fd_info"], opts["json"])
        bits_in, bits_out = FEC_SPECS[cfg.rate]
        info.initial(opts["standard"], rx.cstln.name,
                     f"{bits_in}/{bits_out}", cfg.Fm)
    constw = None
    if opts["fd_const"] >= 0:
        # The scan demod and --hs sample one point per chunk, written in
        # batches of 128 (SYMBOLS); the kernel path samples none (as the
        # JAX kernel path): only its CONST line is written.
        constw = info_mod.ConstWriter(opts["fd_const"], opts["json"])
        constw.const(rx.cstln.symbols)
    specw = None
    if opts["fd_spectrum"] >= 0:
        specw = info_mod.SpectrumWriter(opts["fd_spectrum"], opts["json"])

    itemsize = {"u8": 2, "s8": 2, "u16": 4, "s16": 4, "f32": 8}[opts["input"]]
    stdin = sys.stdin.buffer
    out = sys.stdout.buffer
    CHUNK_BYTES = (1 << 17) * itemsize

    meas_sent = 0
    cnr_sent = 0
    locktime_sent = 0
    spectrum_sent = 0

    def flush_info():
        nonlocal meas_sent, cnr_sent, locktime_sent, spectrum_sent
        if constw:
            pts = rx.sampled_points
            while len(pts) >= 128:
                constw.symbols(pts[:128])
                del pts[:128]
        if specw:
            for line in rx.spectrum_lines[spectrum_sent:]:
                specw.spectrum(line)
            spectrum_sent = len(rx.spectrum_lines)
            specw.f.flush()
        if not info:
            return
        n = len(rx.meas["freq"])
        for k in range(meas_sent, n):
            # freq_tap is cycles/sample at the POST-decimation rate
            info.freq(rx.meas["freq"][k], scale=rx.Fs_eff)
            info.ss(rx.meas["ss"][k])
            info.mer(rx.meas["mer"][k])
        meas_sent = n
        for v in rx.meas["cnr"][cnr_sent:]:
            info.cnr(v)
        cnr_sent = len(rx.meas["cnr"])
        for st in rx.mpeg.lock_events:
            info.lock(st)
        rx.mpeg.lock_events.clear()
        if rx.mpeg.locktime_count > locktime_sent:
            info.locktime(rx.mpeg.locktime)
            locktime_sent = rx.mpeg.locktime_count
        if rx.vbitcount:
            info.vber(rx.vber)
        info.flush()

    while True:
        raw = stdin.read(CHUNK_BYTES)
        if not raw:
            if opts["loop"]:
                # file_reader.loop: lseek to 0 on EOF (generic.h:59-63)
                try:
                    stdin.seek(0)
                    continue
                except OSError:
                    break
            break
        nitems = len(raw) // itemsize * itemsize
        iq = read_iq(raw[:nitems], opts["input"])
        if opts["acq"]:
            # FFT coarse carrier search (dsp/acquisition.py) on the first
            # block: the receiver is rebuilt with --tune seeded by the
            # estimate, so the PLL clamp window is centred on the carrier.
            opts["acq"] = False
            from ..dsp.acquisition import coarse_carrier_estimate
            m = rx.cstln.nsymbols
            m = m if m in (2, 4, 8) else 4
            est = coarse_carrier_estimate(iq, msymbols=m, device=rx.device)
            cfg.Ftune += est * cfg.Fs
            if opts["verbose"]:
                print(f"coarse acquisition: {est * cfg.Fs:+.0f} Hz",
                      file=sys.stderr)
            rx = DvbsReceiver(cfg, device=opts["device"])
        ts = rx.process(iq)
        if cfg.hdlc:
            # HDLC frames (with --packetized behind their 16-bit length)
            # instead of TS.
            if len(rx.hdlc_frames):
                out.write(rx.hdlc_frames.tobytes())
                out.flush()
                rx.hdlc_frames = rx.hdlc_frames[:0]
        elif len(ts):
            out.write(np.ascontiguousarray(ts).tobytes())
            out.flush()
        flush_info()
    flush_info()
    write_trace()
    return 0


if __name__ == "__main__":
    sys.exit(main())
