"""leansdrscan-compatible acquisition supervisor (reference
leansdrscan.cc; the counterpart of leansdr_tpu/apps/leansdrscan.py).

Takes a command template whose fields may contain comma-separated
alternatives, iterates the cartesian product, runs each candidate command
bridging stdin/stdout, kills a candidate after --timeout seconds without
output, and on success either keeps streaming (live mode) or rewinds the
input file and re-executes the winning command (--rewind).

Usage:
  python -m leansdr_tpu_torch.apps.leansdrscan [-t SECONDS] [--rewind] \\
      command [args with,commas ...] < capture.iq > out.ts

--device: the on-device scan. Instead of fork/exec'ing one candidate at
a time, ALL (symbol rate x code rate) hypotheses race concurrently as
batch channels of one scan-demod launch (pipelines/scan_rx.py, per-channel
omega in csrc/scan_demod.cu). The election rule is the reference's
output-production rule (leansdrscan.cc:187-199) applied in grid order;
the winning config is then exec'd as a normal child command (hand-off),
rewound to the start of the file under --rewind, or, live, the scan
receiver keeps decoding in process. Only the command template's --sr and
--cr fields may carry alternatives in this mode. Here `--device` is the
scan's own boolean flag (as in the JAX CLI); the device the scan runs on
is read from the template's `--device NAME` (the port's leandvb flag:
cuda by default, or cpu), so the in-process scan runs where the elected
command will run.
"""

import itertools
import os
import select
import subprocess
import sys
import time


def expand(args):
    """Cartesian product of comma-alternatives (field::iterate,
    leansdrscan.cc:28-37)."""
    choices = [a.split(",") for a in args]
    for combo in itertools.product(*choices):
        yield list(combo)


def run_candidate(cmd, timeout, rewind):
    """run_program (leansdrscan.cc:62-158): bridge stdin -> child ->
    stdout with a no-output watchdog. Returns (success, saw_eof):
    success once the child has produced output; saw_eof when stdin
    ran out (so a live-mode caller can stop respawning candidates)."""
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE)
    stdin_fd = sys.stdin.buffer.fileno()
    out_fd = proc.stdout.fileno()
    in_fd = proc.stdin.fileno()
    # Non-blocking child stdin: a child that stops READING must not
    # defeat the no-output watchdog by blocking our write.
    import fcntl
    fcntl.fcntl(in_fd, fcntl.F_SETFL,
                fcntl.fcntl(in_fd, fcntl.F_GETFL) | os.O_NONBLOCK)
    pending = b""
    success = False
    last_output = time.time()
    stdin_open = True
    try:
        while True:
            rlist = [out_fd]
            wlist = [in_fd] if pending else []
            if stdin_open and not pending:
                rlist.append(stdin_fd)
            r, w, _ = select.select(rlist, wlist, [], 0.5)
            if in_fd in w and pending:
                try:
                    nw = os.write(in_fd, pending)
                    pending = pending[nw:]
                    if not pending and not stdin_open:
                        proc.stdin.close()
                except (BrokenPipeError, BlockingIOError):
                    if isinstance(sys.exc_info()[1], BrokenPipeError):
                        break
            if stdin_fd in r:
                data = os.read(stdin_fd, 65536)
                if not data:
                    stdin_open = False
                    if not pending:
                        proc.stdin.close()
                else:
                    pending = data
                    try:
                        nw = os.write(in_fd, pending)
                        pending = pending[nw:]
                    except BlockingIOError:
                        pass
                    except BrokenPipeError:
                        break
            if out_fd in r:
                data = os.read(out_fd, 65536)
                if data:
                    success = True
                    last_output = time.time()
                    if rewind:
                        break      # will re-run the winner from the start
                    sys.stdout.buffer.write(data)
                    sys.stdout.buffer.flush()
                elif not stdin_open:
                    break
            if not success and time.time() - last_output > timeout:
                break
            if proc.poll() is not None and not success:
                break
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    return success, not stdin_open


def device_scan(template, timeout, rewind):
    """On-device candidate race: parse the --sr/--cr sweeps (and the
    input format, -f, --float-scale and --device) out of the command
    template, run every combination as a batch channel of ONE
    demodulator (pipelines/scan_rx.CandidateScanReceiver), elect the
    first candidate that decodes TS, and exec the winning command (or
    keep decoding in process)."""
    import numpy as np
    from ..dsp import receiver
    from ..pipelines.scan_rx import CandidateScanReceiver
    from ..util.iofmt import read_iq

    fmt, Fs, scale, device = "u8", 2.4e6, 1.0, None
    srs, crs = None, ["1/2"]
    sr_at = cr_at = None
    skip = set()
    for k, a in enumerate(template):
        if k in skip:
            continue
        nxt = template[k + 1] if k + 1 < len(template) else ""
        if a in ("--u8", "--s8", "--u16", "--s16", "--f32"):
            fmt = a[2:]
        elif a == "-f":
            Fs = float(nxt)
            skip.add(k + 1)
        elif a == "--float-scale":
            scale = float(nxt)
            skip.add(k + 1)
        elif a == "--device":
            device = nxt
            skip.add(k + 1)
        elif a == "--sr":
            srs, sr_at = [float(v) for v in nxt.split(",")], k + 1
            skip.add(k + 1)
        elif a == "--cr":
            crs, cr_at = nxt.split(","), k + 1
            skip.add(k + 1)
        elif "," in a and not a.startswith("-"):
            print("** --device scans --sr/--cr alternatives only; "
                  f"'{template[k - 1]} {a}' is not supported",
                  file=sys.stderr)
            return 1
    if not srs:
        print("** --device needs an --sr field in the command",
              file=sys.stderr)
        return 1

    scan = CandidateScanReceiver.grid(Fs, srs, crs, float_scale=scale,
                                      device=device)
    itemsize = {"u8": 2, "s8": 2, "u16": 4, "s16": 4, "f32": 8}[fmt]
    # Build the scan demod BEFORE touching the stream: a scratch receiver
    # fed one chunk of zeros launches it (on the card: the nvcc build and
    # the library load), so a LIVE stream pays neither inside the signal
    # window. PyTorch compiles nothing per shape, so one chunk does.
    warm = CandidateScanReceiver.grid(Fs, srs, crs, float_scale=scale,
                                      device=device)
    warm.process(np.zeros((receiver.CHUNK + warm.params.readahead, 2),
                          np.float32))
    del warm
    stdin = sys.stdin.buffer
    t0 = time.time()
    consumed = 0
    winner = None
    while winner is None and time.time() - t0 < timeout * max(
            1, len(scan.candidates)):
        raw = stdin.read((1 << 16) * itemsize)
        if not raw:
            break
        nitems = len(raw) // itemsize * itemsize
        consumed += nitems // itemsize
        winner = scan.process(read_iq(raw[:nitems], fmt))
    if winner is None:
        print("** device scan: no candidate locked", file=sys.stderr)
        return 1
    c = scan.candidates[winner]
    cmd = list(template)
    if sr_at is not None:
        cmd[sr_at] = f"{c.Fm:g}"
    if cr_at is not None:
        cmd[cr_at] = c.rate
    print(f"Device scan elected: --sr {c.Fm:g} --cr {c.rate} after "
          f"{consumed} samples ({time.time() - t0:.2f}s); "
          + ("exec: " + " ".join(cmd) if rewind
             else "continuing in-process"), file=sys.stderr)
    if rewind:
        # File mode: decode the whole capture fresh with the winning
        # config (reference semantics, leansdrscan.cc:192-196).
        os.lseek(stdin.fileno(), 0, os.SEEK_SET)
        os.execvp(cmd[0], cmd)
    # Live mode: the scan receiver IS a receiver — keep ITS loop state
    # and byte chain (scan_rx.focus), flush everything decoded during
    # the scan (the reference's supervisor discards pre-election
    # output), and stream on with no process restart.
    out = sys.stdout.buffer
    out.write(scan.outputs[winner].tobytes())
    out.flush()
    scan.focus(winner)
    scan.outputs[0] = scan.outputs[0][:0]
    while True:
        raw = stdin.read((1 << 16) * itemsize)
        if not raw:
            break
        nitems = len(raw) // itemsize * itemsize
        scan.process(read_iq(raw[:nitems], fmt))
        if len(scan.outputs[0]):
            out.write(scan.outputs[0].tobytes())
            out.flush()
            scan.outputs[0] = scan.outputs[0][:0]
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    timeout = 2.0
    rewind = False
    device = False
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        if argv[i] in ("-t", "--timeout"):
            i += 1
            timeout = float(argv[i])
        elif argv[i] == "--rewind":
            rewind = True
        elif argv[i] == "--device":
            device = True
        elif argv[i] in ("-v", "-d"):
            pass
        else:
            print(f"** Error while processing '{argv[i]}'", file=sys.stderr)
            return 1
        i += 1
    template = argv[i:]
    if not template:
        print(__doc__, file=sys.stderr)
        return 1
    if device:
        return device_scan(template, timeout, rewind)

    while True:
        saw_eof = False
        for cmd in expand(template):
            print(f"Trying: {' '.join(cmd)}", file=sys.stderr)
            if rewind:
                try:
                    os.lseek(sys.stdin.buffer.fileno(), 0, os.SEEK_SET)
                except OSError:
                    pass
            ok, eof = run_candidate(cmd, timeout, rewind)
            saw_eof = saw_eof or eof
            if ok:
                if rewind:
                    # Reprocess the whole file with the winner
                    # (leansdrscan.cc:187-199).
                    os.lseek(sys.stdin.buffer.fileno(), 0, os.SEEK_SET)
                    os.execvp(cmd[0], cmd)
                return 0
        if rewind or saw_eof:
            return 1    # all candidates failed on a finite stream


if __name__ == "__main__":
    sys.exit(main())
