"""leaniiorx / leaniiotx equivalents (reference leaniiorx.cc,
leaniiotx.cc): AD936x/PlutoSDR capture and playback via libiio (a copy
of leansdr_tpu/apps/leaniio.py).

Usage:
  python -m leansdr_tpu_torch.apps.leaniio rx [options]  > IQ   (int16 I/Q out)
  python -m leansdr_tpu_torch.apps.leaniio tx [options]  < IQ   (int16 I/Q in)

Flags mirror the reference 1:1 (-f LO Hz, -s sample rate, --bw,
--nbufs, --bufsize, --pmp, -v, -d, --version). All device-independent
logic — rate planning, FIR programming, attribute sequencing, sample
streaming, PMP descriptor publishing — is implemented here; the device
itself sits behind a two-method-deep backend:

  * LibiioBackend drives real hardware when the `iio` python bindings
    are installed (`pip install pylibiio`); it stays import-gated, so
    the app runs without them.
  * SimBackend is a behavioral AD936x stand-in: it records every
    attribute write, honors `filter_fir_config` by parsing the uploaded
    taps and actually decimating/interpolating with them, streams RX
    samples from `--sim tone:F` or `--sim file:PATH`, and in `--pmp`
    mode backs its DMA ring in an mmapable file (`--devmem PATH`) so
    the zero-copy path is exercised end-to-end (leansdr_tpu's
    leanmlmrx --pmp consumes the descriptors).

Extensions beyond the reference flag set: `--sim SPEC`, `--devmem PATH`
(CMA stand-in / real /dev/mem), `--count N` (stop after N buffers;
the reference streams until stdout closes).
"""

import sys
import time

import numpy as np

from ..util import ad936x, pmp


class _Config:
    def __init__(self):
        self.Flo = 2449e6        # leaniiorx.cc:56
        self.Fm = 0.0            # 0 = no analog bandpass (Fm := Fs)
        self.Fs = 2.5e6
        self.nbufs = 0
        self.bufsize = 64 * 1024  # samples per buffer
        self.pmp = False
        self.verbose = False
        self.debug = False
        self.sim = None
        self.devmem = "/dev/mem"
        self.count = 0           # 0 = until EOF / stdout close


# ---------------------------------------------------------------------------
# Backends


class LibiioBackend:
    """Real hardware via pylibiio. Attribute names/sequence follow
    leaniiorx.cc:231-318 / leaniiotx.cc:156-243."""

    def __init__(self, cfg):
        import iio  # noqa: F401 — hard requirement for this backend
        self._iio = iio
        self.ctx = iio.Context()
        if not self.ctx.devices:
            raise RuntimeError("No IIO device found")
        self.phy = self.ctx.find_device("ad9361-phy")
        self.cfg = cfg
        self._buf = None

    def chattr(self, chan_name, attr, value, output=False):
        ch = self.phy.find_channel(chan_name, output)
        ch.attrs[attr].value = str(value)

    def devattr(self, attr, value):
        if isinstance(value, bool):
            value = "1" if value else "0"
        self.phy.attrs[attr].value = str(value)

    def open_rx(self, bufsize, nbufs):
        dev = self.ctx.find_device("cf-ad9361-lpc")
        for name in ("voltage0", "voltage1"):
            dev.find_channel(name, False).enabled = True
        if nbufs:
            dev.set_kernel_buffers_count(nbufs)
        self._buf = self._iio.Buffer(dev, bufsize, False)

    def open_tx(self, bufsize, nbufs):
        dev = self.ctx.find_device("cf-ad9361-dds-core-lpc")
        for name in ("voltage0", "voltage1"):
            dev.find_channel(name, True).enabled = True
        if nbufs:
            dev.set_kernel_buffers_count(nbufs)
        self._buf = self._iio.Buffer(dev, bufsize, False)

    def refill(self):
        self._buf.refill()
        return self._buf.read(), None  # no physaddr exposure via pylibiio

    def push(self, raw: bytes):
        self._buf.write(raw)
        self._buf.push()


class SimBackend:
    """Behavioral AD936x stand-in (no hardware required).

    RX: synthesizes/reads the CONVERTER-rate stream, then applies
    whatever `filter_fir_config` the host uploaded (if enabled) exactly
    as the hardware would — parse taps, convolve, decimate.
    TX: zero-stuff interpolation + uploaded FIR, appended to the
    `--sim file:PATH` sink.
    PMP: DMA buffers live in a ring inside the `devmem` file; physaddr
    is the file offset, and the ring recycles after `nbufs` buffers
    (so stale descriptors fail their canary check, like real CMA).
    """

    NBUFS_DEFAULT = 4

    def __init__(self, cfg):
        self.cfg = cfg
        self.attrs = []          # [(kind, name, attr, value)] audit log
        self.fir_text = None
        self.fir_en_in = False
        self.fir_en_out = False
        self._phase = 0.0
        self._file = None
        self._sink = None
        self._bufsize = 0
        self._ring = None
        self._ring_slot = 0
        self._tail = np.zeros((0, 2), np.int16)  # FIR state across buffers
        spec = cfg.sim or "tone:100e3"
        if spec.startswith("file:"):
            path = spec[5:]
            self._file = open(path, "rb") if not _is_tx(cfg) else None
            self._sink = open(path, "wb") if _is_tx(cfg) else None
        elif spec.startswith("tone:"):
            parts = spec[5:].split(",")
            self._tone_f = float(parts[0])
            self._tone_amp = float(parts[1]) if len(parts) > 1 else 2000.0
        else:
            raise ValueError(f"unknown --sim spec '{spec}'")

    # -- attribute plumbing (recorded for tests / -v tracing) ---------------

    def chattr(self, chan_name, attr, value, output=False):
        self.attrs.append(("chan", chan_name, attr, value))
        if self.cfg.debug:
            print(f"sim: {chan_name}.{attr} = {value}", file=sys.stderr)

    def devattr(self, attr, value):
        self.attrs.append(("dev", "ad9361-phy", attr, value))
        if attr == "filter_fir_config":
            self.fir_text = value
        elif attr == "in_voltage_filter_fir_en":
            self.fir_en_in = bool(value)
        elif attr == "out_voltage_filter_fir_en":
            self.fir_en_out = bool(value)
        if self.cfg.debug:
            v = value if not isinstance(value, str) else f"<{len(value)}B>"
            print(f"sim: phy.{attr} = {v}", file=sys.stderr)

    # -- streaming -----------------------------------------------------------

    def open_rx(self, bufsize, nbufs):
        self._bufsize = bufsize
        if self.cfg.pmp:
            n = nbufs or self.NBUFS_DEFAULT
            self._ring = open(self.cfg.devmem, "w+b")
            self._ring.truncate(n * bufsize * 4)
            self._ring_n = n

    open_tx = open_rx

    def _fir(self):
        if not self.fir_text:
            return None, 1
        _, factor, taps = ad936x.parse_fir_config(self.fir_text)
        return taps.astype(np.float64), factor

    def _source(self, n):
        """n converter-rate samples as [n, 2] int16 (I, Q)."""
        if self._file is not None:
            raw = self._file.read(n * 4)
            if len(raw) < 8:
                return None
            return np.frombuffer(raw[:len(raw) // 4 * 4],
                                 dtype=np.int16).reshape(-1, 2)
        w = 2 * np.pi * self._tone_f
        t = self._phase + np.arange(n)
        self._phase += n
        fs = ad936x.plan_rate(self.cfg.Fs).converter_fs
        iq = np.empty((n, 2), np.int16)
        iq[:, 0] = np.round(self._tone_amp * np.cos(w * t / fs))
        iq[:, 1] = np.round(self._tone_amp * np.sin(w * t / fs))
        return iq

    def refill(self):
        """One RX buffer: bytes (s16 interleaved IQ) + physaddr or None."""
        taps, dec = (self._fir() if self.fir_en_in else (None, 1))
        src = self._source(self._bufsize * dec)
        if src is None:
            return None, None
        if taps is not None:
            if len(self._tail) < len(taps) - 1:  # cold start: zero history
                self._tail = np.zeros((len(taps) - 1, 2), np.int16)
            src = np.concatenate([self._tail, src])
            self._tail = src[-(len(taps) - 1):] if len(taps) > 1 else src[:0]
            acc = np.stack([np.convolve(src[:, 0], taps, "valid"),
                            np.convolve(src[:, 1], taps, "valid")], axis=1)
            # hardware coefficient scale: s16 taps, >>15 output shift
            src = np.clip(np.round(acc[::dec] / 32768.0),
                          -32768, 32767).astype(np.int16)
        raw = src.tobytes()
        if self._ring is None:
            return raw, None
        phys = self._ring_slot * self._bufsize * 4
        self._ring.seek(phys)
        self._ring.write(raw)
        self._ring.flush()
        self._ring_slot = (self._ring_slot + 1) % self._ring_n
        return raw, phys

    def push(self, raw: bytes):
        iq = np.frombuffer(raw, dtype=np.int16).reshape(-1, 2)
        taps, itp = (self._fir() if self.fir_en_out else (None, 1))
        if taps is not None:
            up = np.zeros((len(iq) * itp, 2), np.float64)
            up[::itp] = iq * itp  # zero-stuff; gain restores amplitude
            up = np.concatenate([np.asarray(self._tail, np.float64), up])
            self._tail = up[-(len(taps) - 1):] if len(taps) > 1 else up[:0]
            acc = np.stack([np.convolve(up[:, 0], taps, "valid"),
                            np.convolve(up[:, 1], taps, "valid")], axis=1)
            iq = np.clip(np.round(acc / 32768.0),
                         -32768, 32767).astype(np.int16)
        if self._sink is not None:
            self._sink.write(iq.tobytes())
            self._sink.flush()


def _is_tx(cfg):
    return getattr(cfg, "_tx", False)


# ---------------------------------------------------------------------------
# Device bring-up (the reference's run(), hardware-independent)


def _common_setup(cfg, be, direction):
    """rf port, bandwidth, FIR, sampling rate, LO — in the reference's
    order (leaniiorx.cc:244-291, leaniiotx.cc:169-216)."""
    rx = direction == "RX"
    plan = ad936x.plan_rate(cfg.Fs)
    if plan.use_fir and cfg.verbose:
        print(f"Using AD936x FIR {'decimator /4' if rx else 'interpolator x4'}",
              file=sys.stderr)

    be.chattr("voltage0", "rf_port_select",
              "A_BALANCED" if rx else "A", output=not rx)
    if not cfg.Fm:
        if cfg.verbose:
            print("No analog bandpass filtering.", file=sys.stderr)
        cfg.Fm = cfg.Fs
    if cfg.verbose:
        print(f"Setting RF bandwidth {cfg.Fm/1e3:.0f} kHz", file=sys.stderr)
    if cfg.Fm < 200e3:
        print("Warning: Minimum RF bandwidth is 200 kHz", file=sys.stderr)
    be.chattr("voltage0", "rf_bandwidth", int(cfg.Fm), output=not rx)

    sfattr = ("in" if rx else "out") + "_voltage_sampling_frequency"
    firen = ("in" if rx else "out") + "_voltage_filter_fir_en"
    # Select a safe rate regardless of current fir state, then program.
    be.chattr("voltage0", sfattr, ad936x.SAFE_RATE, output=not rx)
    be.devattr(firen, False)
    if plan.use_fir:
        taps = ad936x.quarter_band_taps()
        be.devattr("filter_fir_config",
                   ad936x.fir_config(direction, plan.factor, taps))
        be.devattr(firen, True)
    if cfg.verbose:
        print(f"Setting sampling rate {plan.fs/1e3:.0f} kHz", file=sys.stderr)
    try:
        be.chattr("voltage0", sfattr, plan.fs, output=not rx)
    except Exception:
        # BBPLL cannot satisfy mismatched RX+TX rates: force a matching
        # dummy filter on the opposite direction and retry
        # (leaniiorx.cc:269-283).
        print("Failed to set sampling frequency; retrying with matching "
              f"{'TX interpolation' if rx else 'RX decimation'}.",
              file=sys.stderr)
        oattr = ("out" if rx else "in") + "_voltage_sampling_frequency"
        ofiren = ("out" if rx else "in") + "_voltage_filter_fir_en"
        be.chattr("voltage0", oattr, ad936x.SAFE_RATE, output=rx)
        be.devattr(ofiren, False)
        if plan.use_fir:
            other = "TX" if rx else "RX"
            be.devattr("filter_fir_config",
                       ad936x.fir_config(other, plan.factor,
                                         np.zeros(16, np.int16)))
            be.devattr(ofiren, True)
        be.chattr("voltage0", sfattr, plan.fs, output=not rx)

    if cfg.verbose:
        print(f"Tuning to {cfg.Flo/1e6:.6f} MHz", file=sys.stderr)
    be.chattr("altvoltage0" if rx else "altvoltage1", "frequency",
              int(cfg.Flo), output=True)


def run_rx(cfg, be):
    _common_setup(cfg, be, "RX")
    if cfg.nbufs and cfg.verbose:
        print(f"Allocating {cfg.nbufs} buffers", file=sys.stderr)
    if cfg.verbose:
        print(f"Allocating {cfg.bufsize} samples per buffer", file=sys.stderr)
    be.open_rx(cfg.bufsize, cfg.nbufs)

    out = sys.stdout.buffer
    nbuf = 0
    while not cfg.count or nbuf < cfg.count:
        raw, phys = be.refill()
        if raw is None:
            break
        if cfg.debug:
            print(".", end="", file=sys.stderr, flush=True)
        if not cfg.pmp:
            try:
                out.write(raw)
                out.flush()
            except BrokenPipeError:
                break
        else:
            if phys is None:
                print("** leaniiorx: backend does not expose physical "
                      "addresses; --pmp unavailable", file=sys.stderr)
                return 1
            out.write(pmp.make_descriptor(raw, phys).pack())
            out.flush()
            # Substitute for flow control: sleep half the buffer duration
            # (leaniiorx.cc:145-147).
            time.sleep((len(raw) // 4) / cfg.Fs / 2)
        nbuf += 1
    return 0


def run_tx(cfg, be):
    cfg._tx = True
    _common_setup(cfg, be, "TX")
    be.open_tx(cfg.bufsize, cfg.nbufs)
    nw = cfg.bufsize * 4
    nbuf = 0
    while not cfg.count or nbuf < cfg.count:
        raw = sys.stdin.buffer.read(nw)
        if not raw:
            break
        be.push(raw)
        if cfg.debug:
            print(".", end="", file=sys.stderr, flush=True)
        nbuf += 1
    return 0


# ---------------------------------------------------------------------------
# CLI


def _parse(argv, tx):
    cfg = _Config()
    cfg._tx = tx
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-f":
            cfg.Flo = float(val())
        elif a == "-s":
            cfg.Fs = float(val())
        elif a == "--bw":
            cfg.Fm = float(val())
        elif a == "--nbufs":
            cfg.nbufs = int(val(), 0)
        elif a == "--bufsize":
            cfg.bufsize = int(val(), 0)
        elif a == "--pmp" and not tx:
            cfg.pmp = True
        elif a == "--sim":
            cfg.sim = val()
        elif a == "--devmem":
            cfg.devmem = val()
        elif a == "--count":
            cfg.count = int(val())
        elif a == "-v":
            cfg.verbose = True
        elif a == "-d":
            cfg.debug = True
        elif a == "--version":
            print("leansdr_tpu_torch")
            raise SystemExit(0)
        elif a == "-h":
            print(__doc__, file=sys.stderr)
            raise SystemExit(0)
        else:
            print(f"** unknown option '{a}'", file=sys.stderr)
            raise SystemExit(1)
        i += 1
    return cfg


def _backend(cfg, name):
    if cfg.sim:
        return SimBackend(cfg)
    try:
        return LibiioBackend(cfg)
    except ImportError:
        print(f"** {name}: libiio python bindings not installed and no "
              f"--sim backend requested.\n"
              f"   On SDR hardware: pip install pylibiio.\n"
              f"   Without hardware: --sim tone:FREQ | --sim file:PATH.",
              file=sys.stderr)
        raise SystemExit(1)


def main_rx(argv=None):
    cfg = _parse(sys.argv[1:] if argv is None else argv, tx=False)
    try:
        return run_rx(cfg, _backend(cfg, "leaniiorx"))
    except ad936x.RatePlanError as e:
        print(f"** leaniiorx: {e}", file=sys.stderr)
        return 1


def main_tx(argv=None):
    cfg = _parse(sys.argv[1:] if argv is None else argv, tx=True)
    try:
        return run_tx(cfg, _backend(cfg, "leaniiotx"))
    except ad936x.RatePlanError as e:
        print(f"** leaniiotx: {e}", file=sys.stderr)
        return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("rx", "tx"):
        return (main_rx if argv[0] == "rx" else main_tx)(argv[1:])
    print(__doc__, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
