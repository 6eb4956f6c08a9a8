"""leandvbtx-compatible DVB-S modulator CLI (reference leandvbtx.cc; a
copy of leansdr_tpu/apps/leandvbtx.py).

Usage: python -m leansdr_tpu_torch.apps.leandvbtx [options] < TS > IQ

Streaming: packets are read, modulated and written chunk-by-chunk with
carried filter/encoder state (pipelines.dvbs_tx.TxStream), so the TX can
sit in a live pipe exactly like the reference (every leansdr app is a
streaming process). `--fill` mirrors leandvbtx.cc:186-192 +
file_reader::set_realtime (generic.h:64-77): stdin goes O_NONBLOCK and
blank TS packets (0x47 then zeros) are inserted whenever the source has
no data, so the modulator keeps emitting at rate; pacing comes from
stdout backpressure, as in the reference's scheduler loop.
"""

import errno
import os
import sys

import numpy as np

TS = 188


def _read_packets(fd, buf: bytearray, max_packets: int, fill: bool):
    """Read up to max_packets whole TS packets from fd into `buf`.

    Returns (packets ndarray [n,188], eof). In fill mode a read that
    would block yields one blank packet (generic.h:53-56 emits one
    filler item per run() pass)."""
    eof = False
    want = max_packets * TS
    while len(buf) < want:
        try:
            chunk = os.read(fd, want - len(buf))
        except (BlockingIOError, InterruptedError) as e:
            if isinstance(e, InterruptedError):
                continue
            if fill and len(buf) < TS:
                blank = bytes([0x47]) + bytes(TS - 1)
                n = len(buf) // TS
                # Keep any partial packet queued; emit fillers now.
                pkts = np.frombuffer(bytes(buf[:n * TS]) + blank,
                                     np.uint8).reshape(-1, TS)
                del buf[:n * TS]
                return pkts, False
            break
        if not chunk:
            eof = True
            break
        buf.extend(chunk)
        if len(chunk) < want - (len(buf) - len(chunk)) and len(buf) >= TS:
            # Short read with >=1 whole packet buffered: process what we
            # have now instead of blocking for the full batch (live-pipe
            # streaming); partial packets keep looping (generic.h:72-80).
            break
    n = len(buf) // TS
    pkts = np.frombuffer(bytes(buf[:n * TS]), np.uint8).reshape(-1, TS)
    del buf[:n * TS]
    return pkts, eof


def main(argv=None):
    from ..pipelines import dvbs_tx
    from ..util.iofmt import write_iq

    argv = sys.argv[1:] if argv is None else argv
    cfg = dvbs_tx.TxConfig()
    out_fmt = "f32"
    fill = False
    from ._dvbs_flags import CODE_RATES, CONSTELLATIONS as consts
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            print("Usage: leandvbtx [options] < TS > IQ", file=sys.stderr)
            return 0
        elif a in ("-v", "-d"):
            pass
        elif a == "--cr":
            cfg.rate = val()
            if cfg.rate not in CODE_RATES:
                print(f"** Error while processing '{cfg.rate}'",
                      file=sys.stderr)
                return 1
        elif a == "--const":
            cfg.constellation = consts[val()]
        elif a == "-f":
            v = val()
            if "/" in v:
                cfg.interp, cfg.decim = map(int, v.split("/"))
            else:
                cfg.interp, cfg.decim = int(v), 1
        elif a == "--roll-off":
            cfg.rolloff = float(val())
        elif a == "--rrc-rej":
            cfg.rrc_rej = float(val())
        elif a == "--power":
            cfg.amp = dvbs_tx.power_to_amp(float(val()))
        elif a == "--agc":
            cfg.agc = True
        elif a == "--f32":
            out_fmt = "f32"
        elif a == "--s16":
            out_fmt = "s16"
        elif a == "--fill":
            fill = True
        else:
            print(f"** Error while processing '{a}'", file=sys.stderr)
            return 1
        i += 1

    fd = sys.stdin.buffer.fileno()
    if fill:
        os.set_blocking(fd, False)

    tx = dvbs_tx.TxStream(cfg)
    out = sys.stdout.buffer
    buf = bytearray()
    while True:
        pkts, eof = _read_packets(fd, buf, max_packets=64, fill=fill)
        if len(pkts):
            iq = tx.feed(pkts)
            if len(iq):
                out.write(write_iq(iq, out_fmt))
                out.flush()
        if eof:
            break
        if not len(pkts) and not fill:
            # Blocking stdin returned zero whole packets without EOF:
            # only possible mid-packet; loop to finish the element
            # (generic.h:72-80 "Always stop at element boundary").
            continue
    return 0


if __name__ == "__main__":
    sys.exit(main())
