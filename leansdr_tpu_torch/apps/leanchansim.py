"""leanchansim-compatible channel simulator CLI (reference leanchansim.cc;
a copy of leansdr_tpu/apps/leanchansim.py).

Usage: python -m leansdr_tpu_torch.apps.leanchansim [options] < IQ.in > IQ.out
"""

import sys

import numpy as np


def main(argv=None):
    from ..pipelines import chansim
    from ..util.iofmt import read_iq, write_iq

    argv = sys.argv[1:] if argv is None else argv
    in_fmt = out_fmt = "f32"
    cfg = chansim.ChansimConfig()
    Fs = 0.0
    Flo = 0.0
    ppm = -1.0
    drift_period = drift_rate = 0.0
    drift2_amp = drift2_freq = 0.0
    loop = False
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            print("Usage: leanchansim [options] < IQ.in > IQ.out",
                  file=sys.stderr)
            return 0
        elif a == "--iu8":
            in_fmt = "u8"
        elif a == "--if32":
            in_fmt = "f32"
        elif a == "--ou8":
            out_fmt = "u8"
        elif a == "--of32":
            out_fmt = "f32"
        elif a == "-f":
            Fs = float(val())
        elif a == "--loop":
            loop = True
        elif a == "--scale":
            cfg.scale = float(val())
        elif a == "--awgn":
            # dB -> linear stddev (leanchansim.cc:248-249)
            cfg.awgn = float(np.exp(np.log(10) * float(val()) / 20))
        elif a == "--deterministic":
            cfg.deterministic = True
        elif a == "--lo":
            Flo = float(val())
        elif a == "--ppm":
            ppm = float(val())
        elif a == "--drift-period":
            drift_period = float(val())
        elif a == "--drift-rate":
            drift_rate = float(val())
        elif a == "--drift2-amp":
            drift2_amp = float(val())
        elif a == "--drift2-freq":
            drift2_freq = float(val())
        else:
            print(f"** Error while processing '{a}'", file=sys.stderr)
            return 1
        i += 1

    drifts = [chansim.DriftComponent() for _ in range(3)]
    if Fs:
        maxoffs = Flo * ppm * 1e-6
        drifts[0].amp = maxoffs / Fs
        if drift_period and drift_rate:
            print("Specify only one of --drift-rate and --drift-period",
                  file=sys.stderr)
            return 1
        if drift_period:
            drifts[0].freq = (1.0 / drift_period) / Fs
        if drift_rate:
            if not ppm:
                print("Need --ppm with --drift-rate", file=sys.stderr)
                return 1
            drifts[0].freq = (drift_rate / (2 * np.pi * ppm)) / Fs
        if drift2_amp and drift2_freq:
            drifts[1].amp = drift2_amp / Fs
            drifts[1].freq = drift2_freq / Fs
    cfg.drifts = tuple(drifts)

    if not cfg.deterministic:
        # Reference seeds drand48 with getpid() when not deterministic
        # (leanchansim.cc:146-147); srand48(pid) semantics.
        import os
        cfg.seed = os.getpid()

    raw = sys.stdin.buffer.read()
    iq = read_iq(raw, in_fmt)
    out = chansim.simulate(iq, cfg)
    sys.stdout.buffer.write(write_iq(out, out_fmt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
