"""leansdrcat-compatible constant-bitrate pacing tool (reference
src/apps/leansdrcat.cc): simulates real-time input rate conditions for
testing; optional non-blocking stdout with '#' drop markers (a copy of
leansdr_tpu/apps/leansdrcat.py).
"""

import fcntl
import os
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    block = False
    nonblock = False
    bytespersec = 2400000 * 2
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-h":
            print(__doc__, file=sys.stderr)
            return 0
        elif a == "--block":
            block = True
        elif a == "--nonblock":
            nonblock = True
        elif a == "--cbr":
            i += 1
            bytespersec = int(argv[i]) // 8
        elif a == "--cbr8":
            i += 1
            bytespersec = int(argv[i])
        elif a == "--cbr16":
            i += 1
            bytespersec = int(argv[i]) * 2
        elif a == "--cbr32":
            i += 1
            bytespersec = int(argv[i]) * 4
        elif a == "--cbr64":
            i += 1
            bytespersec = int(argv[i]) * 8
        else:
            print(f"** Error while processing '{a}'", file=sys.stderr)
            return 1
        i += 1

    blocksize = min(4096, bytespersec)
    if not block:
        flags = fcntl.fcntl(1, fcntl.F_GETFL)
        fcntl.fcntl(1, fcntl.F_SETFL, flags | os.O_NONBLOCK)

    t0 = time.monotonic()
    current = 0
    while True:
        reltime = time.monotonic() - t0
        target = int(reltime * bytespersec)
        want = target - current
        if want < blocksize:
            time.sleep(min(blocksize / bytespersec, 1.0))
            continue
        buf = os.read(0, blocksize)
        if not buf:
            return 0
        current += len(buf)
        view = memoryview(buf)
        while len(view):
            try:
                nw = os.write(1, view)
                view = view[nw:]
            except BlockingIOError:
                if not nonblock:
                    sys.stderr.write("#")
                break


if __name__ == "__main__":
    sys.exit(main())
