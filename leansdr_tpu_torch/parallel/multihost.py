"""The multi-process fleet on torch.distributed (the counterpart of
tools/dcn_demo.py, stages 1 and 2).

    python -m leansdr_tpu_torch.parallel.multihost --world N \\
        [--backend nccl|gloo] [--device cpu] [--nchan C] [--chunk n] \\
        [--windows W] [--segments S --seg-warmup n --seg-holdoff k] \\
        [--out DIR] [--init URL] [--timeout SECONDS]

starts N rank processes on this host (rank r on cuda:(r % device_count),
NCCL by default; `--backend gloo` for ranks that share a card,
`--device cpu` for CPU ranks, which need gloo) and prints one JSON line
per rank, in rank order. Each rank:

  1. runs the channel-sharded demod step (parallel/mesh.py) over its
     slice of a C-carrier fleet on one STAGE1_SAMPLES chunk, and the
     time-sharded FIR (parallel/halo.py) over FIR_SAMPLES; the valid
     symbols are summed over the ranks and the MER averaged, and the
     FIR's rate is its block over the slowest rank's time;
  2. builds its own `MultiDvbsReceiver` over its own C/N carriers,
     modulates only those carriers (its ingest, `carrier_iq`), feeds
     them through `util/ingest.DeviceFeeder` in chunks and decodes them
     with its own byte backend (the C++ one), checking each TS packet
     against the packets sent. The decode's host bookkeeping (the ring
     fill that schedules decodes, and the Viterbi's ACQUIRE / TRACK
     switch) is made on the whole fleet's values (`share_bookkeeping`),
     so each carrier's TS equals a single-process fleet's over all C
     carriers, byte for byte. Decoded and verified packets and the
     elapsed time (and the time after the first chunk, which carries
     the one-time set-up) are gathered from every rank.

With `--out DIR` each rank writes carrier c's TS to DIR/ch_<c>.ts. The
launcher gives each rank INIT_TIMEOUT_S to form the group and the whole
run `--timeout` seconds, then kills what is left and fails.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..dsp import filtergen, receiver
from ..dsp.cstln import Predef, make_dvbs2_constellation
from ..pipelines import dvbs_tx, tsgen
from ..pipelines.dvbs_rx import RxConfig
from ..pipelines.multi_rx import MultiDvbsReceiver
from ..util import trace
from ..util.ingest import DeviceFeeder
from . import group as _group
from . import halo, mesh

FS, FM = 4e6, 2e6
SCALE = 75.0            # the ingest applies the fleet's float scale
ESN0_DB = 12.0
SAMPLES_PER_PACKET = 3264   # QPSK 1/2 at 2 samples per symbol
STAGE1_SAMPLES = 4096   # dcn_demo.py's stage-1 chunk
FIR_SAMPLES = 1 << 20   # dcn_demo.py's FIR point
FIR_REPS = 5
REPO = Path(__file__).resolve().parents[2]


def fleet_config() -> RxConfig:
    """The fleet each rank runs: QPSK 1/2 carriers at 2 Msym/s sampled at
    4 Msps, the RRC matched filter and the computed demod (csrc/demod.cu),
    soft Viterbi (csrc/acs.cu), fastlock; the ingest applies the float
    scale (float_scale=1 here)."""
    return RxConfig(Fs=FS, Fm=FM, rate="1/2", fastlock=True, float_scale=1.0,
                    exact_lut=False, viterbi=True, sampler="rrc")


def sent_packets(c: int, nsamp: int) -> np.ndarray:
    """The TS packets carrier c sends over nsamp samples (and a margin):
    numbered from 1000*c."""
    return tsgen.generate(nsamp // SAMPLES_PER_PACKET + 16, start=1000 * c)


def carrier_iq(c: int, nsamp: int) -> np.ndarray:
    """[nsamp, 2] float32 samples of carrier c, scaled by SCALE: the host
    modulator's QPSK 1/2 signal of sent_packets(c), delayed by a fraction
    of a sample, offset by (c % 64 - 32) * 5e-6 cycles per sample, with
    AWGN at ESN0_DB; the same bits from any process (seeded by c)."""
    q = dvbs_tx.modulate(sent_packets(c, nsamp),
                         dvbs_tx.TxConfig(rate="1/2", interp=2))
    if len(q) < nsamp + 1:
        raise ValueError(f"carrier {c}: {len(q)} samples < {nsamp + 1}")
    q = q[:nsamp + 1, 0].astype(np.float64) + 1j * q[:nsamp + 1, 1]
    rng = np.random.default_rng([20261018, c])
    d = rng.uniform()
    z = (1 - d) * q[:-1] + d * q[1:]
    z *= np.exp(2j * np.pi * (c % 64 - 32) * 5e-6 * np.arange(nsamp))
    sigma = np.sqrt(np.mean(np.abs(z) ** 2)) * 10 ** (-ESN0_DB / 20)
    z += sigma / np.sqrt(2) * (rng.standard_normal(nsamp)
                               + 1j * rng.standard_normal(nsamp))
    return (np.stack([z.real, z.imag], -1) * SCALE).astype(np.float32)


def windows(iq: np.ndarray, chunk: int, readahead: int, device):
    """The chunks the fleet reads, [C, ., 2]: on CUDA chunk + readahead
    samples each, overlapping by the readahead (dispatch() reads such a
    device tensor in place); on the CPU `chunk` samples each, which
    dispatch() buffers on the host with its own readahead."""
    ra = readahead if torch.device(device).type == "cuda" else 0
    for o in range(0, iq.shape[1] - ra - chunk + 1, chunk):
        yield iq[:, o:o + chunk + ra]


def share_bookkeeping(rx: MultiDvbsReceiver, group=None):
    """Make rx's host decode bookkeeping fleet-wide: the fill estimate
    takes the minimum over every rank's carriers, and the Viterbi's
    ACQUIRE / TRACK policy reads every rank's discriminants, in rank
    order. Each rank then schedules and switches as one process with all
    the carriers would, so a carrier's bytes do not depend on the
    sharding. Every rank must call rx.process() on the same chunks."""
    dec, dev = rx.deconv, rx.device

    def gathered(a: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return _group.all_gather(t, group).cpu().numpy()

    own_fill = dec.sync_fill
    dec.sync_fill = lambda fill: own_fill(gathered(fill))
    own_observe = getattr(dec, "observe", None)
    if own_observe is not None:
        dec.observe = lambda discr, under: own_observe(
            gathered(discr), gathered(under.astype(np.uint8)).astype(bool))


def _counts() -> dict:
    """The kernels' launch counts in this process."""
    c = trace.counters()
    return {k: c.get(f"launch.{k}", 0)
            for k in ("demod", "demod.pe_table", "acs", "scan_demod", "fir")}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage1(dev, nchan: int) -> dict:
    """dcn_demo's stage 1: the sharded demod step over this rank's slice
    of nchan carriers (all carrier 0's signal), symbols summed and MER
    averaged over the ranks; the sharded FIR's rate."""
    D, r = _group.size(), _group.rank()
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=FS / FM, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    tables = receiver.make_tables(cstln, dev)
    state = mesh.shard_channels(receiver.init_state(params, nchan, dev))
    y = torch.from_numpy(carrier_iq(0, STAGE1_SAMPLES + params.readahead))
    x = y.to(dev)[None].expand(nchan // D, -1, -1).contiguous()
    _, out, mean_mer = mesh.sharded_demod_step(params)(tables, state, x)
    nsym = _group.all_reduce_sum(out["valid"].sum())

    taps = filtergen.root_raised_cosine(32, 0.25, 0.35)
    fir = halo.sharded_fir(taps)
    rng = np.random.default_rng([20261018, r])
    xb = torch.from_numpy(rng.standard_normal(
        (2, FIR_SAMPLES // D)).astype(np.float32)).to(dev)
    fir(xb)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(FIR_REPS):
        fir(xb)
    _sync(dev)
    took = _group.all_gather(torch.tensor(
        [time.perf_counter() - t0], dtype=torch.float64, device=dev))
    return {"fleet_symbols_sum": int(nsym),
            "fleet_mer_mean_db": float(mean_mer),
            "fir_msamples_per_s": FIR_SAMPLES * FIR_REPS
            / float(took.max()) / 1e6}


def stage2(dev, nchan: int, chunk: int, nwin: int, out_dir=None,
           **seg) -> dict:
    """dcn_demo's stage 2: this rank's own fleet over its own carriers,
    fed through DeviceFeeder, decoded by its own byte backend; packets
    decoded and verified and the elapsed time gathered from every
    rank."""
    D, r = _group.size(), _group.rank()
    if nchan % D:
        raise ValueError(f"{nchan} carriers do not split {D} ways")
    mine = range(r * nchan // D, (r + 1) * nchan // D)
    rx = MultiDvbsReceiver(fleet_config(), len(mine), chunk_samples=chunk,
                           device=dev, **seg)
    share_bookkeeping(rx)
    nsamp = nwin * chunk + rx.readahead
    iq = np.stack([carrier_iq(c, nsamp) for c in mine])
    ts = [[] for _ in mine]
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    _sync(dev)
    t0 = time.perf_counter()
    marks = []
    for win in DeviceFeeder(windows(iq, chunk, rx.readahead, dev),
                            device=dev):
        for i, p in enumerate(rx.process(win)):
            ts[i].append(p)
        marks.append(time.perf_counter())
    _sync(dev)
    elapsed = time.perf_counter() - t0
    steady = marks[-1] - marks[0] if len(marks) > 1 else elapsed
    decoded = verified = 0
    for i, c in enumerate(mine):
        pk = np.concatenate(ts[i]) if ts[i] else np.empty((0, 188), np.uint8)
        sent = {p.tobytes() for p in sent_packets(c, nsamp)}
        decoded += len(pk)
        verified += sum(p.tobytes() in sent for p in pk)
        if out_dir is not None:
            (Path(out_dir) / f"ch_{c}.ts").write_bytes(pk.tobytes())
    agg = _group.all_gather(torch.tensor(
        [[decoded, verified, elapsed, steady]], dtype=torch.float64,
        device=dev))
    return {"fleet_decode_backend": type(rx.backend).__name__,
            "fleet_ts_decoded": int(agg[:, 0].sum()),
            "fleet_ts_verified": int(agg[:, 1].sum()),
            "fleet_aggregate_msamples_per_s":
                nchan * nwin * chunk / float(agg[:, 2].max()) / 1e6,
            "fleet_steady_msamples_per_s":
                nchan * max(nwin - 1, 1) * chunk / float(agg[:, 3].max())
                / 1e6,
            "rank_ts_decoded": decoded, "rank_elapsed_s": elapsed}


def run_rank(a) -> dict:
    dev = _group.init(a.rank, a.world, a.init, a.backend, a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)     # the plain versions' many small ops
    try:
        res = {"rank": a.rank, "world": a.world, "backend": a.backend,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
        res |= stage1(dev, a.nchan)
        res |= stage2(dev, a.nchan, a.chunk, a.windows, a.out,
                      segments=a.segments, seg_warmup=a.seg_warmup,
                      seg_holdoff=a.seg_holdoff)
        res["launches"] = _counts()
        return res
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(a, r: int, init: str) -> list:
    argv = [sys.executable, "-m", "leansdr_tpu_torch.parallel.multihost",
            "--rank", str(r), "--init", init]
    for k in ("world", "backend", "nchan", "chunk", "windows", "segments",
              "seg_warmup", "seg_holdoff"):
        argv += [f"--{k.replace('_', '-')}", str(getattr(a, k))]
    for k in ("device", "out"):
        if getattr(a, k) is not None:
            argv += [f"--{k}", str(getattr(a, k))]
    return argv


def launch(a) -> int:
    """Start the a.world ranks, wait for them (a.timeout s in all, then
    kill), print their results in rank order; 0 if every rank finished
    and all agree on the reduced counts."""
    init = a.init or f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(_rank_argv(a, r, init), stdout=subprocess.PIPE,
                              text=True, env=env) for r in range(a.world)]
    deadline = time.monotonic() + a.timeout
    outs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        print(f"multihost: ranks still running after {a.timeout} s",
              file=sys.stderr)
        return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith("{")]
        if p.returncode != 0 or not lines:
            print(f"multihost: rank {r} exited {p.returncode}",
                  file=sys.stderr)
            return 1
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    shared = ("fleet_symbols_sum", "fleet_ts_decoded", "fleet_ts_verified")
    if any(res[k] != results[0][k] for res in results for k in shared):
        print("multihost: the ranks' reduced counts differ", file=sys.stderr)
        return 1
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leansdr_tpu_torch.parallel.multihost",
        description="The multi-process DVB-S fleet on torch.distributed.")
    ap.add_argument("--world", type=int, required=True,
                    help="number of rank processes")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", default=None,
                    help="cpu for CPU ranks (default: CUDA)")
    ap.add_argument("--nchan", type=int, default=16,
                    help="carriers of the whole fleet")
    ap.add_argument("--chunk", type=int, default=1 << 15,
                    help="samples per chunk (a multiple of 128)")
    ap.add_argument("--windows", type=int, default=3,
                    help="chunks per carrier")
    ap.add_argument("--segments", type=int, default=1)
    ap.add_argument("--seg-warmup", type=int, default=2048)
    ap.add_argument("--seg-holdoff", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="directory for each carrier's TS (ch_<c>.ts)")
    ap.add_argument("--init", default=None,
                    help="init_method URL (default: a free TCP port on "
                         "127.0.0.1)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for the whole run")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.device is not None and torch.device(a.device).type == "cpu" \
            and a.backend == "nccl":
        ap.error("--device cpu needs --backend gloo")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.rank is None:
        return launch(a)
    print(json.dumps(run_rank(a)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
