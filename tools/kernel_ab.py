"""Time the demod, fft4096, acs, acs_banked, cfir, fir, scan_demod and
hs_demod kernels of two checkouts of the port in one process on one
card: a parent checkout and this tree.

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
main paths' shapes: 14 and 64 carriers x 2^18 (the S=1 fleet chunk of
the benchmark's fleet and of chip_smoke's), 512 x 2^15 and 448 x 2048
(the S=8 passes), 8192 x 2^15 (every SM: the layout without the
phase-error table, whose blocks would not fit in one wave), one carrier
x 2^17 (a leandvb read, omega 1.2). fft4096 runs at B=1024
over six inputs in turn (192 MB, more than the L2), with torch.fft.fft
timed after each pair. acs runs at the main paths' shapes: the fleet's
ACQUIRE decode (N=256 lanes, T=2^17 blocks), its TRACK decode (N=64,
cheap_q) and the hq 1/2 single carrier's 128-block chunk (N=4), costs
0..-39; outputs equal. cfir runs at the --resample stage's shape (79
taps, 2^17 + 85 samples), full rate and decimated by 7 from sample 79
(a parent without the decimated launch: its full-rate launch and the
gather the stage made of it); outputs equal. acs_banked runs at the
fleet's 3/4 and 7/8 shapes: ACQUIRE (512 lanes x 2^16 blocks; 1024 x
2^15) and TRACK (64 lanes), costs 0..-79, and the hq 3/4 single
carrier's launch (8 lanes x 128 blocks, from CUDA-graph replays); outputs
equal. fir runs at 128 rows x 2^18 samples, 65 taps (the mean of 20
calls); outputs equal. scan_demod runs with the exact LUT at the main
paths' shapes (SCAN_SHAPES): the fleet's rrc launch (64 x 2^18, 4 Msps),
the S=8 fleet's pass 2 (512 x (2^15 + 128)), one carrier's read (1 x
2^17) with the linear sampler at 4 Msps and the rrc sampler at 2.4 Msps,
on noisy QPSK at the sample rate's samples per symbol with the fleet
stimulus's carrier offsets (scaled by the rrc sampler's steps, its
polyphase gain), from one state that a launch of the change left; hs_demod at one carrier's read (1 x 2^17) at omega 2.0
and 1.2 (the --hs stream's), the same stimulus as u8 at 40 LSB; every
output and state plane equal. A time is the wrapper's:
kernel, input transpose and the parent's per-call table copy (cfir and
the N=4 acs: the mean over 50 calls from CUDA-graph replays, as
chip_smoke.py times them, so the host does not pace them). Also counts each side's acs loop chain
per block from its SASS (tools/sass_chain.py, latencies from
tools/latency_probe.cu) and each side's acs_banked block loop per B
(chip_smoke.banked_chain: the shared-memory exchange counted; a loop
nested in the block loop, as the parent's slot loop at B >= 4, is
counted once per block, so its count is a lower bound there). Prints
one line per shape and a JSON line.
"""

import argparse
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (its latency and SASS helpers)

SEED = 20261017
DEMOD_SHAPES = ((14, 1 << 18, 2.0, 2), (64, 1 << 18, 2.0, 2),
                (512, 1 << 15, 2.0, 3), (448, 2048, 2.0, 10),
                (8192, 1 << 15, 2.0, 3), (1, 1 << 17, 1.2, 2))
# (lanes, blocks, cheap_q, calls per timing; GRAPH_CALLS: captured in a
# CUDA graph and replayed)
GRAPH_CALLS = 50
ACS_SHAPES = ((256, 1 << 17, False, 2), (64, 1 << 17, True, 2),
              (4, 128, False, GRAPH_CALLS))
# (rate, lanes, blocks, calls per timing)
BANKED_SHAPES = (("3/4", 512, 1 << 16, 1), ("3/4", 64, 1 << 16, 1),
                 ("7/8", 1024, 1 << 15, 1), ("7/8", 64, 1 << 15, 1),
                 ("3/4", 8, 128, GRAPH_CALLS))
# (lanes, samples, sampler, sample rate, calls per timing)
SCAN_SHAPES = ((64, 1 << 18, "rrc", 4e6, 1),
               (512, (1 << 15) + 128, "rrc", 4e6, 2),
               (1, 1 << 17, "linear", 4e6, 2),
               (1, 1 << 17, "rrc", 2.4e6, 2))
# (lanes, samples, omega, calls per timing)
HS_SHAPES = ((1, 1 << 17, 2.0, 2), (1, 1 << 17, 1.2, 2))


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
                      "dsp.fft_kernel", "dsp.cstln", "dsp.fir_kernel",
                      "fec.viterbi_device", "fec.viterbi_banked",
                      "dsp.receiver_hs", "pipelines.dvbs_rx")}


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


def _clone(st: dict) -> dict:
    return {k: v.clone() for k, v in st.items()}


def _equal(a, b) -> bool:
    """(state, outputs) of two wrappers: every tensor equal."""
    def flat(v):
        if torch.is_tensor(v):
            return [v]
        return [t for k in sorted(v) for t in flat(v[k])] if isinstance(
            v, dict) else [t for w in v for t in flat(w)]
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(torch.equal(u, w)
                                      for u, w in zip(fa, fb))


def scan_case(ports, C, n, sampler, fs, reps, gen, pairs):
    """scan_demod, exact LUT, from the state one launch of the change
    left; each side times its own copy of that state."""
    change = ports["change"]
    co, steps = ((), 1)
    if sampler == "rrc":
        co, steps = change["pipelines.dvbs_rx"].rrc_sampler(
            fs, change["pipelines.dvbs_rx"].RxConfig(Fs=fs, Fm=2e6))
    fields = dict(omega=fs / 2e6, sampler=sampler, exact_lut=True,
                  rrc_coeffs=co, rrc_steps=steps)
    ra = change["dsp.receiver"].ReceiverParams(**fields).readahead
    x = chip_smoke.qpsk_at(C, n + ra - 1, gen, fs / 2e6) * float(steps)
    fns, outs = {}, {}
    st0 = None
    for tag in ("change", "parent"):
        rc = ports[tag]["dsp.receiver"]
        cst = ports[tag]["dsp.cstln"]
        params = rc.ReceiverParams(**fields)
        tables = rc.make_tables(cst.make_dvbs2_constellation(
            cst.Predef.QPSK, "1/2"), x.device)
        if st0 is None:
            st0, _ = rc.run_chunks(params, tables,
                                   rc.init_state(params, C, x.device), x)
            st0 = _clone(st0)
        outs[tag] = rc.run_chunks(params, tables, _clone(st0), x)
        st = _clone(st0)
        fns[tag] = (lambda f, a: lambda: f(*a))(rc.run_chunks,
                                                (params, tables, st, x))
    return dict(kernel="scan_demod",
                shape=f"C={C} nsamp={n} {sampler} exact {fs / 1e6:g} Msps",
                equal=_equal(outs["parent"], outs["change"]),
                **summary(paired(fns, reps, pairs)))


def hs_case(ports, C, n, omega, reps, gen, pairs):
    x = torch.clamp(torch.round(
        chip_smoke.qpsk_at(C, n, gen, omega) * (40 / 75.0) + 128),
        0, 255).to(torch.int32)
    fns, outs = {}, {}
    st0 = None
    for tag in ("change", "parent"):
        hs = ports[tag]["dsp.receiver_hs"]
        params = hs.HsParams(omega=omega)
        tables = hs.hs_tables(x.device)
        if st0 is None:
            st0, _ = hs.run_chunks_hs(params, tables,
                                      hs.init_state(params, C, x.device), x)
            st0 = _clone(st0)
        outs[tag] = hs.run_chunks_hs(params, tables, _clone(st0), x)
        st = _clone(st0)
        fns[tag] = (lambda f, a: lambda: f(*a))(hs.run_chunks_hs,
                                                (params, tables, st, x))
    return dict(kernel="hs_demod", shape=f"C={C} nsamp={n} omega {omega}",
                equal=_equal(outs["parent"], outs["change"]),
                **summary(paired(fns, reps, pairs)))


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


def acs_case(ports, N, T, cheap_q, reps, gen, pairs):
    cs = torch.randint(0, 4, (T, N), device=gen.device, dtype=torch.int32,
                       generator=gen)
    cost = -torch.randint(0, 40, (T, N), device=gen.device,
                          dtype=torch.int32, generator=gen)
    z = torch.zeros((64, N), dtype=torch.int32, device=gen.device)
    fns, outs = {}, {}
    for tag in ("parent", "change"):
        fn = ports[tag]["fec.viterbi_device"].viterbi_acs
        args = ("1/2", z, z, cs, cost, cheap_q)
        outs[tag] = fn(*args)
        fns[tag] = (lambda f, a: lambda: f(*a))(fn, args)
        if reps == GRAPH_CALLS:             # too short: no host pacing
            fns[tag] = graph_call(fns[tag])
    equal = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                   outs["change"]))
    runs = paired(fns, 1 if reps == GRAPH_CALLS else reps, pairs)
    if reps == GRAPH_CALLS:
        runs = {k: [v / GRAPH_CALLS for v in r] for k, r in runs.items()}
    return dict(kernel="acs", shape=f"N={N} T={T} cheap_q={cheap_q}",
                equal=equal, **summary(runs))


def banked_case(ports, rate, N, T, reps, gen, pairs):
    ncs = ports["change"]["fec.viterbi_banked"].bank_geometry(rate).ncs
    cs = torch.randint(0, ncs, (T, N), device=gen.device, dtype=torch.int32,
                       generator=gen)
    cost = -torch.randint(0, 80, (T, N), device=gen.device,
                          dtype=torch.int32, generator=gen)
    z = torch.zeros((64, N), dtype=torch.int32, device=gen.device)
    fns, outs = {}, {}
    for tag in ("parent", "change"):
        fn = ports[tag]["fec.viterbi_banked"].viterbi_acs_banked
        args = (rate, z, z, z, cs, cost)
        outs[tag] = fn(*args)
        fns[tag] = (lambda f, a: lambda: f(*a))(fn, args)
        if reps == GRAPH_CALLS:
            fns[tag] = graph_call(fns[tag])
    equal = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                   outs["change"]))
    runs = paired(fns, 1, pairs)
    if reps == GRAPH_CALLS:
        runs = {k: [v / GRAPH_CALLS for v in r] for k, r in runs.items()}
    return dict(kernel="acs_banked", shape=f"rate {rate} N={N} T={T}",
                equal=equal, **summary(runs))


def fir_case(ports, gen, pairs, reps=20):
    R, n, nt = 128, 1 << 18, 65
    x = torch.randn((R, n), device=gen.device, generator=gen)
    taps = torch.randn(nt, device=gen.device, generator=gen)
    fns, outs = {}, {}
    for tag in ("parent", "change"):
        fn = ports[tag]["dsp.fir_kernel"].fir
        outs[tag] = fn(x, taps)
        fns[tag] = (lambda f: lambda: f(x, taps))(fn)
    return dict(kernel="fir", shape=f"R={R} n={n} nt={nt}",
                equal=torch.equal(outs["parent"], outs["change"]),
                **summary(paired(fns, reps, pairs)))


def graph_call(fn, reps=GRAPH_CALLS):
    """A function that replays `reps` calls of fn captured in one CUDA
    graph (device time without host pacing; cuda_ms divides by 1)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g.replay


def cfir_case(ports, gen, pairs, decimated):
    nt, n, dec = 79, (1 << 17) + 85, 7
    x = 40 * torch.randn((2, n), device=gen.device, generator=gen)
    tr, ti = (torch.randn(nt, device=gen.device, generator=gen)
              for _ in range(2))
    count = (n - nt) // dec
    fns, outs = {}, {}
    for tag in ("parent", "change"):
        fk = ports[tag]["dsp.fir_kernel"]
        takes_step = "step" in inspect.signature(fk.cfir).parameters
        if not decimated:
            fn = (lambda f: lambda: f(x, tr, ti))(fk.cfir)
        elif takes_step:
            fn = (lambda f: lambda: f(x, tr, ti, nt, dec, count))(fk.cfir)
        else:                     # the stage's full-rate launch and gather
            idx = nt + torch.arange(count, device=gen.device) * dec
            fn = (lambda f: lambda: f(x, tr, ti)[:, idx])(fk.cfir)
        outs[tag] = fn()
        fns[tag] = graph_call(fn)
    equal = torch.equal(outs["parent"], outs["change"])
    runs = paired(fns, 1, pairs)
    runs = {k: [v / GRAPH_CALLS for v in r] for k, r in runs.items()}
    shape = (f"n={n} nt={nt}" + (f" start={nt} step={dec} count={count}"
                                 if decimated else " full rate"))
    return dict(kernel="cfir", shape=shape, equal=equal, **summary(runs))


def acs_chains(ports, dev) -> dict:
    """Each side's acs loop chain per block from its SASS: the parent's
    (shuffle reductions: ACS_LEGACY_FUNCTIONS) where it has no REDUX."""
    clock = chip_smoke.max_sm_clock_hz()
    lat, lat_int = chip_smoke.latency_table(chip_smoke.start_probe_build(),
                                            dev)
    out, banked = {}, {}
    keys = ("function", "unroll", "cycles_per_step", "issue_cycles_per_step",
            "path_instructions_per_step", "instructions_per_step", "mix")
    for tag in ("parent", "change"):
        so = ports[tag]["device"].build(["acs"])["acs"][0]
        fns = (chip_smoke.ACS_FUNCTIONS
               if "REDUX" in chip_smoke.sass_of(so)
               else chip_smoke.ACS_LEGACY_FUNCTIONS)
        print(f"[{tag}]")
        out[tag] = {m: {k: r[k] for k in keys}
                    for m, r in chip_smoke.acs_chain(so, lat_int, clock,
                                                     fns).items()}
        so = ports[tag]["device"].build(["acs_banked"])["acs_banked"][0]
        banked[tag] = {B: {k: r[k] for k in keys}
                       for B, r in chip_smoke.banked_chain(
                           so, lat_int, clock).items()}
    return dict(latency_cycles=lat_int, clock_hz=clock, chains=out,
                banked_chains=banked)


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
        m["device"].build(["demod", "fft4096", "acs", "acs_banked", "fir",
                           "scan_demod", "hs_demod"])
    chains = acs_chains(ports, torch.device("cuda", 0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = [acs_case(ports, N, T, cq, reps, gen, a.pairs)
            for N, T, cq, reps in ACS_SHAPES]
    rows += [banked_case(ports, rate, N, T, reps, gen, a.pairs)
             for rate, N, T, reps in BANKED_SHAPES]
    rows += [cfir_case(ports, gen, a.pairs, d) for d in (False, True)]
    rows.append(fir_case(ports, gen, a.pairs))
    rows += [demod_case(ports, C, n, om, reps, gen, a.pairs)
             for C, n, om, reps in DEMOD_SHAPES]
    rows.append(fft_case(ports, gen, a.pairs))
    rows += [scan_case(ports, C, n, smp, fs, reps, gen, a.pairs)
             for C, n, smp, fs, reps in SCAN_SHAPES]
    rows += [hs_case(ports, C, n, om, reps, gen, a.pairs)
             for C, n, om, reps in HS_SHAPES]
    for r in rows:
        sides = "; ".join(
            f"{k} {r[k]['median']:.4f} ms ({r[k]['q1']:.4f}-{r[k]['q3']:.4f})"
            for k in ("parent", "change", "cufft") if k in r)
        print(f"{r['kernel']} {r['shape']}: {sides}; change faster in "
              f"{r['change_wins']} of {a.pairs} pairs; outputs "
              f"{'agree' if r['equal'] else 'DIFFER'}")
    print(json.dumps({"card": card, "acs_chains": chains, "rows": rows}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
