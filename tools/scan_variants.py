"""The scan demod kernel (leansdr_tpu_torch/csrc/scan_demod.cu) beside
variants of its own source on one card: the choices its source note
names, timed in one process.

    python3 tools/scan_variants.py [--rounds 3]

Each variant is the committed source with one change made as text:

  * trig16 computed in double: the exact sampler's (cos, sin) entry
    computed as the table was made (the u16 angle's float32 radians,
    cos and sin in double precision, rounded to float32) in place of the
    table gather; the computed entries are checked against the table on
    all 65536 angles;
  * trig16 prefetch: each sample prefetches into L1 the trig16 lines of
    the next sample's gathers (the phase advanced by freqw, before the
    PLL's correction);
  * least carveout: the launch asks for the least shared-memory carveout
    that holds one block, not the blocks one SM gets.

Each is built with nvcc into leansdr_tpu_torch/_build/scan_variants/,
checked equal to the committed kernel on every output and state plane
at each shape, and timed in rounds (the order turned each round; CUDA
events, the mean of three calls after one) at chip_smoke.SCAN_TIMED's
shapes on chip_smoke's stimulus: the exact fleet's launch (64 x 2^18,
rrc at 4 Msps), the S=8 fleet's pass 2 (512 x (2^15 + 128)), one
carrier's read (1 x 2^17) with the linear sampler at 4 Msps and the rrc
sampler at 2.4 Msps. Prints one line per variant and shape and a JSON
line.
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
import chip_smoke  # noqa: E402  (its stimulus, shapes and timing helpers)

SEED = 20261019
TRIG_GATHER = """    const float2 e = __ldg(trig + i);
    c = e.x;
    s = e.y;"""
TRIG_DOUBLE = """    const float af =
        __double2float_rn(((double)i * (2.0 * PI_D)) / 65536.0);
    double sd, cd;
    sincos((double)af, &sd, &cd);
    c = __double2float_rn(cd);
    s = __double2float_rn(sd);"""
TRIG_ALL = """
__global__ void trig_all_kernel(float2* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float c, s;
  expi<true>(nullptr, (float)i, c, s);
  out[i] = make_float2(c, s);
}

extern "C" int trig_all(void* out) {
  trig_all_kernel<<<256, 256>>>((float2*)out);
  return (int)cudaDeviceSynchronize();
}
"""
SAMPLE_HEAD = """      int32_t word = 0;
"""
PREFETCH = """      int32_t word = 0;
      if (EXACT) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            trig + (__float2int_rz(-(phase + freqw)) & 0xFFFF)));
        if (SAMPLER == LINEAR)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(
              trig + (__float2int_rz(-(phase + freqw + chunk_freqw)) &
                      0xFFFF)));
      }
"""
PER_SM = "  const long long per_sm = (C + sms - 1) / sms;"


def variants(src: str) -> dict:
    """{name: source}: the committed kernel and its one-change variants."""
    out = {"committed": src,
           "trig16 computed in double":
               src.replace(TRIG_GATHER, TRIG_DOUBLE) + TRIG_ALL,
           "trig16 prefetch": src.replace(SAMPLE_HEAD, PREFETCH),
           "least carveout": src.replace(
               PER_SM, "  const long long per_sm = 1;")}
    for name, text in out.items():
        if name != "committed" and text.replace(TRIG_ALL, "") == src:
            raise RuntimeError(f"variant {name!r}: the source has changed")
    return out


def build(name: str, text: str, flags: list, nvcc: str, out_dir: Path):
    """Start nvcc on one variant. Returns (process, library path)."""
    tag = name.replace(" ", "_")
    src = out_dir / f"scan_{tag}.cu"
    src.write_text(text)
    so = out_dir / f"libscan_{tag}.so"
    return subprocess.Popen([nvcc] + flags + [str(src), "-o", str(so)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so: Path, argtypes):
    lib = ctypes.CDLL(str(so))
    lib.scan_demod_launch.restype = ctypes.c_int
    lib.scan_demod_launch.argtypes = argtypes
    return lib


def qpsk_tables(dev):
    from leansdr_tpu_torch.dsp import receiver
    from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
    return receiver.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                                dev)


def cases(dev, gen):
    """(key, params, tables, x, start state) per chip_smoke.SCAN_TIMED
    shape, the state one committed launch over x left."""
    from leansdr_tpu_torch.dsp import receiver
    frames = chip_smoke.fleet_frames(dev, gen, "1/2")
    x24 = chip_smoke.stimulus_24(frames, (1 << 17) + 64)
    tables = qpsk_tables(dev)
    out = []
    for key, C, n, sampler, fs, _ in chip_smoke.SCAN_TIMED:
        p = chip_smoke.scan_params(sampler, True, fs)
        n1 = n + p.readahead
        if key == "pass2":
            x = torch.cat([frames[:, o:o + n1] for o in range(
                0, 8 << 15, 1 << 15)]).contiguous()
        elif fs == 2.4e6:
            x = x24[:, :n1].contiguous()
        else:
            x = frames[:C, :n1].contiguous()
        st, _ = receiver.run_chunks(p, tables, receiver.init_state(p, C, dev),
                                    x)
        out.append((key, p, tables, x, st))
    del frames
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    from leansdr_tpu_torch import device as kdev
    from leansdr_tpu_torch.dsp import receiver
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    out_dir = kdev.BUILD / "scan_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags, _ = kdev._target("scan_demod")
    srcs = variants((kdev.CSRC / "scan_demod.cu").read_text())
    procs = {k: build(k, v, flags, kdev.nvcc_path(), out_dir)
             for k, v in srcs.items()}
    argtypes = receiver._kernel().scan_demod_launch.argtypes
    libs = {}
    for k, (p, so) in procs.items():
        text, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            print(f"nvcc failed for {k!r}:\n{text}", file=sys.stderr)
            return 1
        libs[k] = load(so, argtypes)
    # The computed entries against the table, every angle.
    trig = qpsk_tables(dev)["trig"]
    got = torch.empty_like(trig)
    lib = libs["trig16 computed in double"]
    lib.trig_all.restype = ctypes.c_int
    lib.trig_all.argtypes = [ctypes.c_void_p]
    if lib.trig_all(got.data_ptr()) != 0:
        print("trig_all failed", file=sys.stderr)
        return 1
    differ = int((got != trig).any(dim=1).sum())
    print(f"trig16 computed in double: {65536 - differ} of 65536 angles "
          "equal the table")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    shapes = cases(dev, gen)
    equal = {}
    for key, p, tables, x, st in shapes:
        receiver._lib = libs["committed"]
        want = chip_smoke._flat(receiver.run_chunks(p, tables, st, x))
        for k, lb in libs.items():
            receiver._lib = lb
            have = chip_smoke._flat(receiver.run_chunks(p, tables, st, x))
            equal[(k, key)] = all(torch.equal(u, w)
                                  for u, w in zip(want, have))
    names = list(libs)
    runs = {(k, key): [] for k in names for key, *_ in shapes}
    for r in range(a.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in order:
            receiver._lib = libs[k]
            for key, p, tables, x, st in shapes:
                runs[(k, key)].append(chip_smoke.cuda_time(
                    lambda: receiver.run_chunks(p, tables, st, x), reps=3))
    receiver._lib = libs["committed"]
    rows = []
    for (k, key), v in runs.items():
        row = dict(variant=k, shape=key, median_ms=float(np.median(v)),
                   runs_ms=v, equal=equal[(k, key)])
        rows.append(row)
        print(f"{k:28s} {key:16s} {row['median_ms']:9.3f} ms (runs "
              + ", ".join(f"{t:.3f}" for t in v) + "); outputs "
              + ("equal" if row["equal"] else "DIFFER"))
    print(json.dumps({"card": card, "trig16_double_differ": differ,
                      "rows": rows}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
