"""leantsgen-compatible TS generator CLI (reference leantsgen.cc; a copy
of leansdr_tpu/apps/leantsgen.py over the port's pipelines/tsgen.py)."""

import sys


def main(argv=None):
    from ..pipelines import tsgen

    argv = sys.argv[1:] if argv is None else argv
    count = -1
    i = 0
    while i < len(argv):
        if argv[i] == "-c" and i + 1 < len(argv):
            i += 1
            count = int(argv[i])
        else:
            print(f"** Error while processing '{argv[i]}'", file=sys.stderr)
            return 1
        i += 1
    out = sys.stdout.buffer
    t = 0
    while count < 0 or t < count:
        n = min(1024, count - t) if count >= 0 else 1024
        out.write(tsgen.generate(n, start=t).tobytes())
        t += n
    return 0


if __name__ == "__main__":
    sys.exit(main())
