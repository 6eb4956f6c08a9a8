"""Time the demod and fft4096 kernels of two checkouts of the port in one
process on one card: a parent checkout and this tree.

    git archive <parent> | tar -x -C .chip_archive/parent
    python3 tools/kernel_ab.py --parent .chip_archive/parent

Each checkout's `leansdr_tpu_torch` is imported under its own name and
builds its own kernels into its own `_build/`. Every shape is timed in
`--pairs` pairs of parent and change (10), alternating which runs
first (CUDA events, the mean of a few calls after one warm-up each); it
prints each side's median and quartiles and the pairs the change won.
The two outputs are compared:
the demod's packed words and state planes must be equal (both equal
`demod_ref`), fft4096's within 2e-5 of each other (max|dy| / max|y|).
The demod runs on noisy 2x-oversampled QPSK at the AGC setpoint, at the
main paths' shapes: 64 carriers x 2^18 (the S=1 fleet chunk), 512 x
(2^15 + 128) and 448 x 2048 (the S=8 passes), 8192 x 2^15 (every SM),
one carrier x 2^17 (a leandvb read, omega 1.2). fft4096 runs at B=1024
over six inputs in turn (192 MB, more than the L2), with torch.fft.fft
timed after each pair. A time is the wrapper's: kernel, input transpose
and the parent's per-call table copy. Prints one line per shape and a
JSON line.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 20261017
DEMOD_SHAPES = ((64, 1 << 18, 2.0, 2), (512, (1 << 15) + 128, 2.0, 3),
                (448, 2048, 2.0, 10), (8192, 1 << 15, 2.0, 3),
                (1, 1 << 17, 1.2, 2))


def load_port(root: Path, alias: str):
    """The `leansdr_tpu_torch` package under `root`, imported as
    `alias` (its relative imports resolve inside it)."""
    pkg = root / "leansdr_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{alias}.{m}")
            for m in ("device", "dsp.receiver", "dsp.receiver_kernel",
                      "dsp.fft_kernel", "dsp.cstln")}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def qpsk(C: int, n: int, gen) -> torch.Tensor:
    """[C, n+1, 2]: random QPSK at 2 samples per symbol, amplitude ~75,
    per-carrier fractional delays, noise."""
    dev = gen.device
    sym = (torch.randint(0, 2, (C, n // 2 + 2, 2), device=dev,
                         generator=gen) * 2 - 1).float() * 53.0
    s = sym.repeat_interleave(2, dim=1)[:, :n + 2]
    d = torch.rand((C, 1, 1), device=dev, generator=gen)
    x = (1 - d) * s[:, :-1] + d * s[:, 1:]
    return (x + 6.0 * torch.randn(x.shape, device=dev, generator=gen)
            ).contiguous()


def paired(fns: dict, reps: int, pairs: int) -> dict:
    """PAIRS pairs of parent and change, alternating which runs first;
    any other entry of `fns` (cuFFT) runs after each pair. Returns
    {name: [ms per run]}."""
    runs = {k: [] for k in fns}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for k in order + tuple(k for k in fns if k not in order):
            runs[k].append(cuda_ms(fns[k], reps))
    return runs


def summary(runs: dict) -> dict:
    """Median and quartiles per side, and the pairs the change won."""
    out = {k: dict(median=float(np.median(v)),
                   q1=float(np.percentile(v, 25)),
                   q3=float(np.percentile(v, 75)), runs=v)
           for k, v in runs.items()}
    out["change_wins"] = sum(c < p for p, c in zip(runs["parent"],
                                                    runs["change"]))
    return out


def demod_case(ports, C, n, omega, reps, gen, pairs):
    x = qpsk(C, n, gen)
    fns, outs = {}, {}
    for tag in ("parent", "change"):
        m = ports[tag]
        params = m["dsp.receiver"].ReceiverParams(
            omega=omega, sampler="linear", nsymbols=4, exact_lut=False)
        sc = m["dsp.receiver_kernel"].sym_constants(
            m["dsp.cstln"].make_dvbs2_constellation(
                m["dsp.cstln"].Predef.QPSK, "1/2"))
        planes = m["dsp.receiver_kernel"].pack_state(
            m["dsp.receiver"].init_state(params, C, x.device))
        demod = m["dsp.receiver_kernel"].demod
        outs[tag] = demod(params, sc, planes, x)
        fns[tag] = (lambda d, a: lambda: d(*a))(demod, (params, sc, planes,
                                                        x))
    equal = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                   outs["change"]))
    return dict(kernel="demod", shape=f"C={C} nsamp={n}", equal=equal,
                **summary(paired(fns, reps, pairs)))


def fft_case(ports, gen, pairs, reps=60):
    B, N = 1024, 4096
    xs = [tuple(torch.randn((B, N), device=gen.device, generator=gen)
                for _ in range(2)) for _ in range(6)]
    xcs = [(torch.complex(*x),) for x in xs]
    fns, outs = {}, {}

    def turns(fn, items):
        i = [0]

        def call():
            fn(*items[i[0] % len(items)])
            i[0] += 1
        for _ in range(len(items)):
            call()
        return call

    for tag in ("parent", "change"):
        fn = ports[tag]["dsp.fft_kernel"].fft4096
        outs[tag] = torch.complex(*fn(*xs[0]))
        fns[tag] = turns(fn, xs)
    fns["cufft"] = turns(torch.fft.fft, xcs)
    d = outs["parent"] - outs["change"]
    rel = float(d.abs().max() / outs["parent"].abs().max())
    return dict(kernel="fft4096", shape=f"B={B}, 6 inputs in turn",
                equal=rel < 2e-5, rel=rel,
                **summary(paired(fns, reps, pairs)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the parent commit")
    ap.add_argument("--pairs", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    ports = {"parent": load_port(a.parent.resolve(), "port_parent"),
             "change": load_port(REPO, "port_change")}
    for m in ports.values():
        m["device"].build(["demod", "fft4096"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = [demod_case(ports, C, n, om, reps, gen, a.pairs)
            for C, n, om, reps in DEMOD_SHAPES]
    rows.append(fft_case(ports, gen, a.pairs))
    for r in rows:
        sides = "; ".join(
            f"{k} {r[k]['median']:.4f} ms ({r[k]['q1']:.4f}-{r[k]['q3']:.4f})"
            for k in ("parent", "change", "cufft") if k in r)
        print(f"{r['kernel']} {r['shape']}: {sides}; change faster in "
              f"{r['change_wins']} of {a.pairs} pairs; outputs "
              f"{'agree' if r['equal'] else 'DIFFER'}")
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
