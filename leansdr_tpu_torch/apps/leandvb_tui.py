"""Terminal dashboard for the leandvb info stream (the equivalent of the
reference's leandvb_tui.sh / leandvb_vt100ui.sh shell UIs, which consume
the same tagged-line protocol and also work unchanged against our CLI;
a copy of leansdr_tpu/apps/leandvb_tui.py).

Usage:
  python -m leansdr_tpu_torch.apps.leandvb [...] --fd-info 3 3>&1 >out.ts | \\
      python -m leansdr_tpu_torch.apps.leandvb_tui
"""

import sys


FIELDS = ["STANDARD", "CONSTELLATION", "CR", "SR",
          "SS", "MER", "CNR", "FREQ", "LOCK", "LOCKTIME", "VBER"]


def render(state, out):
    out.write("\x1b[H\x1b[2J")           # VT100 home + clear
    out.write("== leansdr_tpu receiver ==\n")
    for k in FIELDS:
        v = state.get(k, "-")
        bar = ""
        try:
            if k == "MER":
                bar = "#" * max(0, min(40, int(float(v) * 2)))
            elif k == "SS":
                bar = "#" * max(0, min(40, int(float(v) / 4)))
        except ValueError:
            pass
        out.write(f"{k:14s} {v:>12s}  {bar}\n")
    out.flush()


def main(argv=None):
    state = {}
    last = 0
    import time
    for line in sys.stdin:
        parts = line.strip().split(None, 1)
        if len(parts) == 2 and parts[0].isupper():
            state[parts[0]] = parts[1]
        now = time.monotonic()
        if now - last > 0.2:
            render(state, sys.stdout)
            last = now
    render(state, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
