#!/usr/bin/env python3
"""MER and lock of the JAX single-carrier receiver on a 2 Msym/s rate-1/2
carrier sampled at 2.4 Msps through two front ends, with no noise:

  brick-wall  resample_poly(z, 6, 5): the 2-sps modulation resampled to
              2.4 Msps by a polyphase filter that cuts at 1.2 MHz, so the
              DVB-S excess band (up to 1.35 MHz) is removed;
  fold-back   resample_poly(z, 6, 1)[3::10]: upsampled x6 and every 10th
              sample kept with no further filter, so the excess band
              folds back in-band (the stimulus of chip_smoke.py's
              canonical stream).

Receiver: leandvb's defaults for `-f 2.4e6 --sr 2e6 --cr 1/2` on the
kernel path (use_pallas=True, exact_lut=False; the Pallas demod in
interpret mode on the CPU), --anf 0 (there is no tone to notch), hard
decisions, measurements every 4800 samples (Finfo 500); the linear
sampler (the default) on both front ends, and --sampler rrc (a matched
filter before the demod) on the brick-wall one.

    JAX_PLATFORMS=cpu python tools/frontend_mer.py [--samples N]

Prints one line per front end: the MER readings (dB) of the second half
of the run, lock, locktime and TS packets out.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from leansdr_tpu.pipelines import dvbs_rx, dvbs_tx, tsgen  # noqa: E402

FRONT_ENDS = {
    "brick-wall": lambda z: resample_poly(z, 6, 5),
    "fold-back": lambda z: resample_poly(z, 6, 1)[3::10],
}
RUNS = (("brick-wall", "linear"), ("fold-back", "linear"),
        ("brick-wall", "rrc"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=1 << 17)
    a = ap.parse_args()
    npkt = int(a.samples / 1.2 * 2 / 1632) + 16
    iq = dvbs_tx.modulate(tsgen.generate(npkt),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    z0 = iq[:, 0] + 1j * iq[:, 1]
    for name, sampler in RUNS:
        z = FRONT_ENDS[name](z0)[:a.samples]
        x = np.stack([z.real, z.imag], -1).astype(np.float32)
        x *= np.float32(1.0 / np.sqrt(np.mean(np.abs(z) ** 2) / 2))
        rx = dvbs_rx.DvbsReceiver(dvbs_rx.RxConfig(
            Fs=2.4e6, Fm=2e6, rate="1/2", float_scale=75.0, anf=0,
            exact_lut=False, use_pallas=True, Finfo=500.0, sampler=sampler))
        npk = 0
        for o in range(0, len(x), 1 << 14):
            npk += len(rx.process(x[o:o + (1 << 14)]))
        mer = np.array(rx.meas["mer"])
        tail = mer[len(mer) // 2:]
        print(f"{name:10s} {sampler:6s} samples {len(x)}: MER {tail.min():.2f}.."
              f"{tail.max():.2f} dB (median {np.median(tail):.2f}) over the "
              f"last {len(tail)} readings; lock {rx.lock}, locktime "
              f"{rx.locktime}, TS packets {npk}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
