"""AD936x (PlutoSDR-class) rate planning and FIR configuration (a copy of
leansdr_tpu/util/ad936x.py).

Hardware-independent logic shared by leaniiorx/leaniiotx
(reference leaniiorx.cc:206-229, leaniiotx.cc:131-154):

  RX:  downconverter -> analog LPF -> ADC -> half-band decimators
       -> 128-tap programmable FIR (dec 1..4)
  TX:  the mirror chain with interpolators.

Rate support windows (both directions use the same breakpoints):
  61.44 MHz .. 25 MHz  : native converter rates
  25 MHz .. 2083333 Hz : the IIO driver engages half-band stages itself
  2083333 .. 520833 Hz : the host must program the FIR at dec/int 4
  below 520833 Hz      : needs FPGA decimation (not implemented,
                         matching the reference)

The programmable FIR is loaded through the `filter_fir_config` device
attribute as text: a header line `RX <chanmask> GAIN <dB> DEC <d>` (or
`TX .. INT <i>`) followed by one signed 16-bit coefficient per line.
Tap count must be a multiple of 16, at most 128; the TX path silently
fails with fewer than 64 taps (leaniiotx.cc:109-110), so TX filters are
zero-padded to 64.

The quarter-band taps are designed here (Hamming-windowed sinc with the
same 0.1125..0.125 transition band the reference targets) rather than
copied: the config-string FORMAT is hardware protocol, the coefficient
VALUES are not.
"""

from dataclasses import dataclass

import numpy as np

RATE_MAX = 61_440_000      # max converter rate (Hz)
RATE_HB_MIN = 2_083_333    # below this the host FIR (dec/int 4) is needed
RATE_FIR_MIN = 520_833     # below this needs FPGA decimation: unsupported
SAFE_RATE = 2_500_000      # rate used while reprogramming the FIR


class RatePlanError(ValueError):
    pass


@dataclass
class RatePlan:
    fs: int                # requested baseband rate (Hz)
    use_fir: bool          # program + enable the dec/int-4 FIR
    factor: int            # FIR decimation/interpolation factor (1 or 4)

    @property
    def converter_fs(self) -> int:
        """Rate seen at the FIR's fast side."""
        return self.fs * self.factor


def plan_rate(fs: float) -> RatePlan:
    """Map a requested baseband rate onto the AD936x filter chain
    (leaniiorx.cc:220-229)."""
    bb = int(fs)
    if bb > RATE_MAX:
        raise RatePlanError("Requested sampling rate is too high")
    if bb < RATE_FIR_MIN:
        raise RatePlanError(
            "Requested sampling rate needs FPGA decimation (not implemented)")
    if bb < RATE_HB_MIN:
        return RatePlan(bb, use_fir=True, factor=4)
    return RatePlan(bb, use_fir=False, factor=1)


def quarter_band_taps(ntaps: int = 32) -> np.ndarray:
    """int16 quarter-band lowpass for the dec/int-4 FIR.

    Hamming-windowed sinc centered on the 0.1125..0.125 transition band
    (cutoff 0.11875 of the fast rate). Scaled so the peak tap uses the
    full s16 coefficient range the hardware accepts.
    """
    if ntaps % 16 or not 16 <= ntaps <= 128:
        raise ValueError("AD936x FIR length must be 16*[1..8]")
    t = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    fc = 0.11875
    x = 2 * np.pi * fc * t
    h = 2 * fc * np.where(t == 0, 1.0,
                          np.divide(np.sin(x), x, out=np.ones_like(x),
                                    where=(t != 0)))
    h *= np.hamming(ntaps)
    h /= h.max()
    return np.round(h * 32700).astype(np.int16)


def fir_config(direction: str, factor: int, taps: np.ndarray,
               chanmask: int = 3, gain_db: int = 0) -> str:
    """Render a `filter_fir_config` attribute string.

    `direction` is 'RX' (DEC) or 'TX' (INT). TX filters shorter than 64
    taps are zero-padded symmetrically to 64 (hardware quirk,
    leaniiotx.cc:109-110).
    """
    direction = direction.upper()
    if direction not in ("RX", "TX"):
        raise ValueError("direction must be RX or TX")
    word = "DEC" if direction == "RX" else "INT"
    taps = np.asarray(taps, dtype=np.int16)
    if direction == "TX" and len(taps) < 64:
        pad = 64 - len(taps)
        taps = np.concatenate([np.zeros(pad // 2, np.int16), taps,
                               np.zeros(pad - pad // 2, np.int16)])
    if len(taps) % 16 or not 16 <= len(taps) <= 128:
        raise ValueError("AD936x FIR length must be 16*[1..8]")
    lines = [f"{direction} {chanmask} GAIN {gain_db} {word} {factor}"]
    lines += [str(int(c)) for c in taps]
    return "\n".join(lines) + "\n"


def parse_fir_config(text: str):
    """Inverse of fir_config (used by the simulated backend to apply
    whatever filter the host uploaded). Returns (direction, factor,
    int16 taps)."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    head = lines[0].split()
    direction = head[0]
    factor = int(head[head.index("DEC" if direction == "RX" else "INT") + 1])
    taps = np.array([int(v) for v in lines[1:]], dtype=np.int16)
    return direction, factor, taps
