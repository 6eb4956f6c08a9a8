"""The rate-1/2 ACS kernel (leansdr_tpu_torch/csrc/acs.cu), or the banked
ACS kernel (csrc/acs_banked.cu), beside variants of its own source on one
card: the design choices its source note names, timed in one process.

    python3 tools/acs_variants.py [--rounds 3] [--kernel acs_banked]

Each variant is the committed source with one change made as text:
four warps per CTA (the kernel's earlier launch shape), one unroll
factor for both modes (4, 8 or 16 blocks per loop pass), and the best
and second-best reductions as five shuffle+min levels instead of one
REDUX. Each is
built with nvcc into leansdr_tpu_torch/_build/acs_variants/, checked
equal to the committed kernel on every output, counted from its SASS
(tools/sass_chain.py: the loop-carried chain and one warp's in-order
issue per trellis block, latencies from tools/latency_probe.cu), and
timed in rounds at the main paths' shapes: the fleet's ACQUIRE (N=256,
T=2^17) and TRACK (N=64, cheap_q) decodes (CUDA events, two calls) and
the hq 1/2 single carrier's 128-block chunk (N=4; CUDA-graph replays of
50 calls). Prints one line per variant and a JSON line.

The banked kernel's variants: half and twice the independent running
minima, and the launch without
its 8-CTAs-per-SM occupancy bound. Each is checked equal to the
committed kernel on every output at its shapes, counted from its SASS
(chip_smoke.banked_chain) and timed in rounds at the fleet's 3/4 and
7/8 ACQUIRE (512 lanes x 2^16 blocks, 1024 x 2^15) and TRACK (64 lanes)
decodes (CUDA events, two calls) and the hq 3/4 single carrier's launch
(8 lanes x 128 blocks; CUDA-graph replays of 50 calls).
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (its latency, SASS and timing helpers)

SEED = 20261018
SHAPES = ((256, 1 << 17, False), (64, 1 << 17, True), (4, 128, False))
GRAPH_CALLS = 50
# The loops of the shuffle-reduction variant, as chip_smoke's
# ACS_FUNCTIONS name the committed kernel's: 20 SHFL per ACQUIRE block
# (2 inputs, 8 metric and path, 5 + 5 reduction levels), 16.25 per
# TRACK block (the second 5 on one block in four).
SHUFFLE_FUNCTIONS = {"acquire": ("acs_kernelILb0E", "SHFL", 20.0, 1),
                     "track": ("acs_kernelILb1E", "SHFL", 16.25, 1)}
WARP_MIN = """
__device__ __forceinline__ int warp_min_shfl(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

"""


def variants(src: str) -> dict:
    """{name: source}: the committed kernel and its one-change variants."""
    unroll = "constexpr int UNROLL = CHEAP_Q ? 8 : 16;"
    out = {"committed": src,
           "four warps per CTA": src.replace(
               "constexpr int WARPS_PER_BLOCK = 1;",
               "constexpr int WARPS_PER_BLOCK = 4;"),
           "shuffle reductions": src.replace(
               "// One half (h = 0", WARP_MIN + "// One half (h = 0").replace(
               "__reduce_min_sync(FULL, ", "warp_min_shfl(")}
    for u in (4, 8, 16):
        out[f"unroll {u}"] = src.replace(
            unroll, f"constexpr int UNROLL = {u};")
    for name, text in out.items():
        if name != "committed" and text == src:
            raise RuntimeError(f"variant {name!r}: the source has changed")
    return out


BANKED_SHAPES = (("3/4", 512, 1 << 16), ("3/4", 64, 1 << 16),
                 ("7/8", 1024, 1 << 15), ("7/8", 64, 1 << 15),
                 ("3/4", 8, 128))


def banked_variants(src: str) -> dict:
    """{name: source}: the committed banked kernel and its one-change
    variants."""
    nacc = "constexpr int NACC = K >= 32 ? 8 : 4;"
    out = {"committed": src,
           "half the running minima": src.replace(
               nacc, "constexpr int NACC = K >= 32 ? 4 : 2;"),
           "twice the running minima": src.replace(
               nacc, "constexpr int NACC = K >= 32 ? 16 : 8;"),
           "no occupancy bound": src.replace(
               "__launch_bounds__(64, 8)", "__launch_bounds__(64)")}
    for name, text in out.items():
        if name != "committed" and text == src:
            raise RuntimeError(f"variant {name!r}: the source has changed")
    return out


def build(sources: dict, kernel: str = "acs") -> dict:
    """nvcc each source (in parallel) -> {name: (loaded library, path)}."""
    from leansdr_tpu_torch import device as kdev
    out_dir = kdev.BUILD / f"{kernel}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        cmd = ([kdev.nvcc_path()] + kdev.ARCH + kdev.BASE_FLAGS
               + kdev.KERNEL_FLAGS[kernel] + [str(cu), "-o", str(so)])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (p, so) in procs.items():
        text, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        if kernel == "acs":
            lib.acs_launch.restype = ctypes.c_int
            lib.acs_launch.argtypes = ([ctypes.c_void_p] * 9
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        else:
            lib.acs_banked_launch.restype = ctypes.c_int
            lib.acs_banked_launch.argtypes = ([ctypes.c_void_p] * 12
                                              + [ctypes.c_int] * 7
                                              + [ctypes.c_void_p])
        libs[name] = (lib, so)
    return libs


def launcher(lib, tbl):
    """acs through `lib` with the wrapper's contract (rate 1/2)."""
    def run(metric, path, cs, cost, cheap_q):
        T, N = cs.shape
        m2, p2 = torch.empty_like(metric), torch.empty_like(path)
        us = torch.empty((T, N), dtype=torch.int32, device=cs.device)
        q = torch.empty_like(us)
        err = lib.acs_launch(tbl.data_ptr(), metric.data_ptr(),
                             path.data_ptr(), cs.data_ptr(), cost.data_ptr(),
                             m2.data_ptr(), p2.data_ptr(), us.data_ptr(),
                             q.data_ptr(), T, N, 31, int(cheap_q),
                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"acs_launch: CUDA error {err}")
        return m2, p2, us, q
    return run


def banked_launcher(lib):
    """acs_banked through `lib` with the wrapper's contract."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    from leansdr_tpu_torch.fec.viterbi import PATH_SPEC

    def run(rate, metric, hi, lo, cs, cost):
        T, N = cs.shape
        geo = vb.bank_geometry(rate)
        nbits, depth = PATH_SPEC[rate]
        rk, aux = vb._device_tables(rate, cs.device)
        out = [torch.empty_like(metric) for _ in range(3)]
        us = torch.empty((T, N), dtype=torch.int32, device=cs.device)
        q = torch.empty_like(us)
        err = lib.acs_banked_launch(
            rk.data_ptr(), aux.data_ptr(), metric.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), cs.data_ptr(), cost.data_ptr(),
            *(o.data_ptr() for o in out), us.data_ptr(), q.data_ptr(), T, N,
            geo.B, nbits, (depth - 1) * nbits - 32, geo.rank_bits, geo.ncs,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"acs_banked_launch: CUDA error {err}")
        return (*out, us, q)
    return run


def banked_main(rounds: int, card: str) -> int:
    """The banked kernel's variants (module docstring)."""
    from leansdr_tpu_torch.fec import viterbi_banked as vb
    dev = torch.device("cuda", 0)
    probe = chip_smoke.start_probe_build()
    src = (REPO / "leansdr_tpu_torch/csrc/acs_banked.cu").read_text()
    libs = build(banked_variants(src), "acs_banked")
    clock = chip_smoke.max_sm_clock_hz()
    _, lat_int = chip_smoke.latency_table(probe, dev)
    runs = {k: banked_launcher(lib) for k, (lib, _) in libs.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    inputs = []
    for rate, N, T in BANKED_SHAPES:
        ncs = vb.bank_geometry(rate).ncs
        cs = torch.randint(0, ncs, (T, N), device=dev, dtype=torch.int32,
                           generator=gen)
        cost = -torch.randint(0, 80, (T, N), device=dev, dtype=torch.int32,
                              generator=gen)
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)
        inputs.append((rate, z, z, z, cs, cost))
    rows, graphs = {}, {}
    for name, run in runs.items():
        equal = all(all(torch.equal(u, v) for u, v in zip(
            run(*x), runs["committed"](*x))) for x in inputs)
        print(f"[{name}]")
        chain = chip_smoke.banked_chain(libs[name][1], lat_int, clock)
        rows[name] = dict(equal=equal, ms={i: [] for i in range(
            len(inputs))}, chain={B: {k: r[k] for k in (
                "cycles_per_step", "issue_cycles_per_step",
                "instructions_per_step")} for B, r in chain.items()})
        x = inputs[-1]
        run(*x)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(GRAPH_CALLS):
                run(*x)
        graphs[name] = g
    for rnd in range(rounds):
        names = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
        for name in names:
            for i in range(len(inputs) - 1):
                rows[name]["ms"][i].append(chip_smoke.cuda_time(
                    lambda: runs[name](*inputs[i]), reps=2))
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            graphs[name].replay()
            e.record()
            torch.cuda.synchronize()
            rows[name]["ms"][len(inputs) - 1].append(
                s.elapsed_time(e) / GRAPH_CALLS)
    for name, r in rows.items():
        med = [float(np.median(r["ms"][i])) for i in range(len(inputs))]
        r["median_ms"] = med
        r["cycles_per_block"] = [m * 1e-3 * clock / BANKED_SHAPES[i][2]
                                 for i, m in enumerate(med)]
        print(f"{name:26s} outputs {'equal' if r['equal'] else 'DIFFER'}; "
              + "; ".join(
                  f"{BANKED_SHAPES[i][0]} N={BANKED_SHAPES[i][1]} "
                  f"T={BANKED_SHAPES[i][2]}: {med[i]:.4f} ms "
                  f"({r['cycles_per_block'][i]:.1f} cycles per block)"
                  for i in range(len(inputs)))
              + "; SASS chain / in-order issue per block: 3/4 "
              f"{r['chain'][3]['cycles_per_step']:.1f} / "
              f"{r['chain'][3]['issue_cycles_per_step']:.1f}, 7/8 "
              f"{r['chain'][7]['cycles_per_step']:.1f} / "
              f"{r['chain'][7]['issue_cycles_per_step']:.1f}")
    print(json.dumps({"card": card, "clock_hz": clock,
                      "latency_cycles": lat_int, "variants": rows}))
    return 0 if all(r["equal"] for r in rows.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernel", choices=("acs", "acs_banked"),
                    default="acs")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("acs_variants: no CUDA device", file=sys.stderr)
        return 2
    from leansdr_tpu_torch.fec import viterbi_device as vd
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    if a.kernel == "acs_banked":
        return banked_main(a.rounds, card)
    probe = chip_smoke.start_probe_build()
    src = (REPO / "leansdr_tpu_torch/csrc/acs.cu").read_text()
    libs = build(variants(src))
    clock = chip_smoke.max_sm_clock_hz()
    _, lat_int = chip_smoke.latency_table(probe, dev)
    tbl = vd._device_tables("1/2", dev)
    runs = {k: launcher(lib, tbl) for k, (lib, _) in libs.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    inputs = []
    for N, T, cq in SHAPES:
        cs = torch.randint(0, 4, (T, N), device=dev, dtype=torch.int32,
                           generator=gen)
        cost = -torch.randint(0, 40, (T, N), device=dev, dtype=torch.int32,
                              generator=gen)
        z = torch.zeros((64, N), dtype=torch.int32, device=dev)
        inputs.append((z, z, cs, cost, cq))
    rows = {}
    for name, run in runs.items():
        equal = all(all(torch.equal(u, v) for u, v in zip(
            run(*x), runs["committed"](*x))) for x in inputs)
        print(f"[{name}]")
        chain = chip_smoke.acs_chain(
            libs[name][1], lat_int, clock,
            None if "REDUX" in chip_smoke.sass_of(libs[name][1])
            else SHUFFLE_FUNCTIONS)
        rows[name] = dict(equal=equal, ms={i: [] for i in range(3)},
                          chain={m: {k: r[k] for k in (
                              "cycles_per_step", "issue_cycles_per_step",
                              "instructions_per_step")}
                              for m, r in chain.items()})
    graphs = {}
    for name, run in runs.items():
        x = inputs[2]
        run(*x)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(GRAPH_CALLS):
                run(*x)
        graphs[name] = g
    for rnd in range(a.rounds):
        names = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
        for name in names:
            for i in range(2):
                rows[name]["ms"][i].append(chip_smoke.cuda_time(
                    lambda: runs[name](*inputs[i]), reps=2))
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            graphs[name].replay()
            e.record()
            torch.cuda.synchronize()
            rows[name]["ms"][2].append(s.elapsed_time(e) / GRAPH_CALLS)
    for name, r in rows.items():
        med = [float(np.median(r["ms"][i])) for i in range(3)]
        r["median_ms"] = med
        r["cycles_per_block"] = [m * 1e-3 * clock / SHAPES[i][1]
                                 for i, m in enumerate(med)]
        print(f"{name:20s} outputs {'equal' if r['equal'] else 'DIFFER'}; "
              + "; ".join(
                  f"N={SHAPES[i][0]} T={SHAPES[i][1]}: {med[i]:.4f} ms "
                  f"({r['cycles_per_block'][i]:.1f} cycles per block)"
                  for i in range(3))
              + "; SASS chain / in-order issue per block: ACQUIRE "
              f"{r['chain']['acquire']['cycles_per_step']:.1f} / "
              f"{r['chain']['acquire']['issue_cycles_per_step']:.1f}, TRACK "
              f"{r['chain']['track']['cycles_per_step']:.1f} / "
              f"{r['chain']['track']['issue_cycles_per_step']:.1f}")
    print(json.dumps({"card": card, "clock_hz": clock,
                      "latency_cycles": lat_int, "variants": rows}))
    return 0 if all(r["equal"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
