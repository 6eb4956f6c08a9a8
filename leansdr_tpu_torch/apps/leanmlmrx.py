"""leanmlmrx-compatible multi-channel FM receiver CLI (reference
src/apps/leanmlmrx.cc:760-867; the counterpart of
leansdr_tpu/apps/leanmlmrx.py).

Usage: python -m leansdr_tpu_torch.apps.leanmlmrx [options] CHANNEL ...
       < IQ > AUDIO
Reads int16 I/Q from stdin (or, with --pmp, PMP descriptors of buffers
in physical memory, as leaniio --pmp publishes them), writes int8 mono
audio (or 8-bit WAV with --wav) to stdout.
Channel syntax: FreqMHz | Min:Step:Max | (...) for initially muted.
Options: --fs --fc -N --fq --maxdev --deemph --squelch --fa --wav
--fd-info --fd-control (MUTE n / UNMUTE n commands) --pmp --devmem;
--device cuda (default) or cpu: where the receiver runs (cpu: the same
torch ops on the host).
"""

import struct
import sys

import numpy as np


def write_wav_header(out, fau):
    """write_wav_header (leanmlmrx.cc:513-528): 8-bit mono PCM."""
    out.write(b"RIFF" + struct.pack("<I", 0) + b"WAVE")
    out.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, int(fau),
                                    int(fau), 1, 8))
    out.write(b"data" + struct.pack("<I", 0))


def parse_channel(cfg_channels, spec, Channel):
    enabled = True
    if spec.startswith("(") and spec.endswith(")"):
        enabled = False
        spec = spec[1:-1]
    if ":" in spec:
        fmin, fstep, fmax = (float(v) for v in spec.split(":"))
        f = fmin
        while f <= fmax + 1e-9:
            cfg_channels.append(Channel(F=f * 1e6, enabled=enabled))
            f += fstep
    else:
        cfg_channels.append(Channel(F=float(spec) * 1e6, enabled=enabled))


class _ControlChannel:
    """Non-blocking MUTE/UNMUTE command channel (poll_control,
    leanmlmrx.cc:332-349). Accepts the same commands, including the
    HTTP-style GET forms the reference tolerates."""

    def __init__(self, fd: int):
        import os
        os.set_blocking(fd, False)
        self.fd = fd
        self._buf = b""

    def poll(self, enabled: np.ndarray):
        import os
        try:
            chunk = os.read(self.fd, 4096)
        except BlockingIOError:
            chunk = b""
        except OSError:
            return
        self._buf += chunk
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            cmd = line.decode("ascii", "replace").strip()
            for pat, val in (("MUTE ", False), ("UNMUTE ", True),
                             ("GET /MUTE=", False), ("GET /UNMUTE=", True)):
                if cmd.startswith(pat):
                    try:
                        arg = int(cmd[len(pat):].split()[0])
                    except (ValueError, IndexError):
                        break
                    if 0 <= arg < len(enabled):
                        enabled[arg] = val
                    break
            else:
                if cmd:
                    print(f"Ignoring unrecognized command '{cmd}'",
                          file=sys.stderr)


def main(argv=None):
    from ..pipelines.mlm_rx import MlmReceiver, MlmConfig, Channel

    argv = sys.argv[1:] if argv is None else argv
    cfg = MlmConfig()
    fd_info = -1
    fd_control = -1
    use_pmp = False
    device = None
    devmem = "/dev/mem"
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            print(__doc__, file=sys.stderr)
            return 0
        elif a == "--fs":
            cfg.Fs = float(val())
        elif a == "--fc":
            cfg.Fc = float(val())
        elif a == "-N":
            cfg.N = int(val())
        elif a == "--fq":
            cfg.Fq = float(val())
        elif a == "--maxdev":
            cfg.maxdev = float(val())
        elif a == "--deemph":
            cfg.deemph = float(val())
        elif a == "--squelch":
            cfg.squelch = float(val())
        elif a == "--fa":
            cfg.Fau = float(val())
        elif a == "--wav":
            cfg.wav = True
        elif a == "--fd-info":
            fd_info = int(val())
        elif a in ("--info-rate", "--spectrum-size", "--spectrum-zoom"):
            val()
        elif a == "--fd-control":
            fd_control = int(val())
        elif a == "--pmp":
            use_pmp = True
        elif a == "--devmem":
            devmem = val()
        elif a == "--device":
            device = val()
        else:
            parse_channel(cfg.channels, a, Channel)
        i += 1

    rx = MlmReceiver(cfg, device=device)
    print(f"IQ sample rate {cfg.Fs/1000:.3f} kHz", file=sys.stderr)
    print(f"Channel quadrature rate {rx.Fq/1000:.3f} kHz", file=sys.stderr)
    print(f"Audio rate {rx.Fau:.0f} Hz", file=sys.stderr)
    print(f"Realtime requires {rx.Fq:.0f} {cfg.N}-point FFTs per second "
          f"(one batched DFT per read here)", file=sys.stderr)

    out = sys.stdout.buffer
    if cfg.wav:
        write_wav_header(out, rx.Fau)
    control = _ControlChannel(fd_control) if fd_control >= 0 else None

    def _reader_pmp():
        """thread_reader_pmp (leanmlmrx.cc:353-376): each stdin record
        is a PMP descriptor; the samples stay in shared memory."""
        from ..util import pmp
        while True:
            rec = sys.stdin.buffer.read(pmp.DESC_SIZE)
            if len(rec) < pmp.DESC_SIZE:
                return
            try:
                buf = pmp.map_buffer(pmp.parse(rec), devmem=devmem)
            except ValueError as e:
                print(f"PMP: Buffer overrun ({e})", file=sys.stderr)
                continue
            yield np.frombuffer(buf, dtype=np.int16).reshape(-1, 2)

    def _reader_pipe():
        CH = 1 << 20
        while True:
            raw = sys.stdin.buffer.read(CH * 4)
            if not raw:
                return
            n = len(raw) // 4 * 4
            yield np.frombuffer(raw[:n], dtype=np.int16).reshape(-1, 2)

    for s16 in (_reader_pmp() if use_pmp else _reader_pipe()):
        iq = (s16[:, 0].astype(np.float32)
              + 1j * s16[:, 1].astype(np.float32)).astype(np.complex64)
        au = rx.process(iq)
        if len(au):
            out.write(au.tobytes())
            out.flush()
        if control is not None:
            control.poll(rx.enabled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
