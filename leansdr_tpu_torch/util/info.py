"""The tagged-line monitoring protocol (the reference's public API).

Mirrors the --fd-info / --fd-const streams
(leandvb.cc:143-155, 598-656; consumed by leandvb_tui.sh,
leandvb_vt100ui.sh, leansdrserv and the bench harness):

  startup: STANDARD, CONSTELLATION, CR, SR
  periodic: FREQ (Hz), SS, MER (dB), LOCK 0|1, LOCKTIME (packets),
            CNR (dB), VBER
  fd-const: CONST (constellation points)
  fd-spectrum: SPECTRUM (1024 dB bins)
  --json switches to JSON array forms.

(A copy of leansdr_tpu/util/info.py.)
"""

import os


class InfoWriter:
    def __init__(self, fd: int, json: bool = False):
        self.f = os.fdopen(fd, "w") if isinstance(fd, int) else fd
        self.json = json

    def initial(self, standard: str, constellation: str, cr: str, sr: float):
        q = '"' if self.json else ""
        self.f.write(f"STANDARD {q}{standard}{q}\n")
        self.f.write(f"CONSTELLATION {q}{constellation}{q}\n")
        self.f.write(f"CR {q}{cr}{q}\n")
        self.f.write(f"SR {sr:f}\n")
        self.f.flush()

    def freq(self, v, scale=1.0):
        self.f.write(f"FREQ {v * scale:.0f}\n")

    def ss(self, v):
        self.f.write(f"SS {v:f}\n")

    def mer(self, v):
        self.f.write(f"MER {v:.1f}\n")

    def lock(self, v: int):
        self.f.write(f"LOCK {int(v)}\n")

    def locktime(self, v: int):
        self.f.write(f"LOCKTIME {int(v)}\n")

    def cnr(self, v):
        self.f.write(f"CNR {v:.1f}\n")

    def vber(self, v):
        self.f.write(f"VBER {v:.6f}\n")

    def flush(self):
        self.f.flush()


class ConstWriter:
    def __init__(self, fd: int, json: bool = False):
        self.f = os.fdopen(fd, "w") if isinstance(fd, int) else fd
        self.json = json

    def const(self, symbols):
        if self.json:
            pts = ",".join(f"[{int(re)},{int(im)}]" for re, im in symbols)
            self.f.write(f"CONST [{pts}]\n")
        else:
            pts = " ".join(f"{int(re)},{int(im)}" for re, im in symbols)
            self.f.write(f"CONST {len(symbols)} {pts}\n")
        self.f.flush()

    def symbols(self, iq):
        """A batch of sampled IQ points (fixed_size=128 in the reference)."""
        if self.json:
            pts = ",".join(f"[{re:.0f},{im:.0f}]" for re, im in iq)
            self.f.write(f"SYMBOLS [{pts}]\n")
        else:
            pts = " ".join(f"{re:.0f},{im:.0f}" for re, im in iq)
            self.f.write(f"SYMBOLS {len(iq)} {pts}\n")


class SpectrumWriter:
    def __init__(self, fd: int, json: bool = False):
        self.f = os.fdopen(fd, "w") if isinstance(fd, int) else fd
        self.json = json

    def spectrum(self, line):
        if self.json:
            vals = ",".join(f"{v:.3f}" for v in line)
            self.f.write(f"SPECTRUM [{vals}]\n")
        else:
            vals = " ".join(f"{v:.3f}" for v in line)
            self.f.write(f"SPECTRUM {len(line)} {vals}\n")
