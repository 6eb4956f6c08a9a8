"""The port's multi-GPU modules (leansdr_tpu_torch.parallel: halo, mesh,
timeshard, group) on gloo ranks on the CPU, against the port's unsharded
runs and the JAX package (leansdr_tpu.parallel on its virtual CPU
devices, and leansdr_tpu.dsp.receiver.run_chunks unsharded).

Ranks are child processes (this file run as a script), each joined
through a FileStore under the test's tmp_path (no fixed port: xdist runs
several workers), with a 60 s init timeout; every child is waited for at
most JOIN_TIMEOUT_S and killed after it. One pair of ranks runs halo at
D=2, the mesh step and the ring; four ranks run halo at D=4.

Stimuli (NumPy, seeded): the halo's is tests/test_parallel.py:89-104's
(8*4096 complex normal samples, rrc taps 32/0.25/0.35); the demod's is
8 QPSK 1/2 carriers as tests/test_parallel.py's _stimulus makes them
(packets numbered from 1000*c, 2 samples per symbol), delayed by a
fraction of a sample each.

The demod runs from a JAX checkpoint: the JAX fleet (exact LUT, linear
sampler, the scan demod) takes one 4096-sample read of the stimulus and
saves its state; `convert.from_jax_checkpoint` turns it into the port's,
the ranks shard it (`mesh.shard_channels`) and carry on over the next
N = 2048 samples. The JAX side runs in one child process with multiply-add
contraction off (XLA_FLAGS=--xla_cpu_max_isa=AVX, as
tests/test_torch_scan_demod.py explains).

Tolerance:
  * halo: the port's sharded FIR equals its unsharded fir_ref bit for
    bit; against np.convolve(x, c)[:n] (float64) and against JAX's
    sharded FIR within HALO_BAR x max|y| (float32 sums in other orders);
  * mesh: the port's sharded outputs and state equal its unsharded
    run_chunks exactly; symbol and valid equal JAX's unsharded
    run_chunks exactly, the float state within the bars of
    tests/test_receiver_pallas.py:36-39; mean_mer within MER_RTOL of
    JAX's sharded_demod_step on 2 of its devices (float32 means summed
    in another order);
  * ring (D=2, the first 2 carriers, 2 supersteps of 8 chunks): symbol
    and valid equal JAX's unsharded run_chunks exactly, and the port's
    ring equals its unsharded run in every output and the final state;
    diagonal_layout / undiagonal equal JAX's at D=8.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from leansdr_tpu_torch.convert import from_jax_checkpoint
from leansdr_tpu_torch.dsp import filtergen, fir_kernel
from leansdr_tpu_torch.dsp import receiver as T
from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.parallel import group, halo, mesh, timeshard
from leansdr_tpu_torch.pipelines import dvbs_tx, tsgen
from leansdr_tpu_torch.pipelines.dvbs_rx import state_from_numpy

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
JOIN_TIMEOUT_S = 120
HALO_BAR = 1e-5
MER_RTOL = 1e-4
C = 8                      # carriers of the demod stimulus
READ = 4096                # the JAX fleet's read before its checkpoint
N = 2 * 8 * T.CHUNK        # samples the mesh and the ring demodulate
B = 8 * T.CHUNK            # the ring's block
FLEET = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, float_scale=75,
             exact_lut=True, viterbi=False, sampler="linear")
# The fleet's demod parameters (MultiDvbsReceiver builds these from
# FLEET, in both packages).
PARAMS = dict(omega=2.0, sampler="linear", nsymbols=4, freq0=0.0,
              exact_lut=True, pll_adjustment=1.0)


def _fir_inputs():
    rng = np.random.default_rng(0)
    n = 8 * 4096
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    return x, filtergen.root_raised_cosine(32, 0.25, 0.35)


def _demod_inputs():
    """[C, READ + N + 1, 2] float32 carriers (unscaled)."""
    rows = []
    for c in range(C):
        q = dvbs_tx.modulate(tsgen.generate(16, start=1000 * c),
                             dvbs_tx.TxConfig(rate="1/2", interp=2))
        d = 0.15 + 0.1 * c
        rows.append(((1 - d) * q[:-1] + d * q[1:])[:READ + N + 1])
    return np.stack(rows).astype(np.float32)


def _planes(x: np.ndarray) -> np.ndarray:
    return np.stack([x.real, x.imag]).astype(np.float32)


def _wait_for(path: Path, timeout: float) -> bytes:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.1)
    return path.read_bytes()


def _ckpt_state(blob: bytes):
    """The converted checkpoint's demod state and where its stream
    stopped (the read less the fleet's sample backlog)."""
    d = pickle.loads(from_jax_checkpoint(blob))
    st = state_from_numpy(d["dev"], False, T.ReceiverParams(**PARAMS),
                          "cpu")
    return st, READ - d["sample_backlog"].shape[1]


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def rank_main(r: int, D: int, work: Path):
    """One rank: halo over its block; with D=2 also the mesh step from
    the converted JAX checkpoint and the ring over the first D carriers.
    Writes its results to work/rank<r>_<D>.pkl."""
    group.init(r, D, f"file://{work / f'store{D}'}", "gloo", "cpu")
    res = {}
    try:
        x, coeffs = _fir_inputs()
        b = len(x) // D
        xb = torch.from_numpy(_planes(x)[:, r * b:(r + 1) * b].copy())
        res["halo"] = halo.sharded_fir(coeffs)(xb).numpy()
        if D == 2:
            st, at = _ckpt_state(_wait_for(work / "ckpt.pkl",
                                           JOIN_TIMEOUT_S))
            p = T.ReceiverParams(**PARAMS)
            tables = T.make_tables(
                make_dvbs2_constellation(Predef.QPSK, "1/2"), "cpu")
            xs = torch.from_numpy(_demod_inputs()[:, at:at + N + 1] * 75)
            step = mesh.sharded_demod_step(p)
            s2, o2, mer = step(tables, mesh.shard_channels(st),
                               mesh.shard_channels(xs))
            res["mesh"] = (_np(mesh.gather_channels(s2)),
                           _np(mesh.gather_channels(o2)), float(mer))
            ins = timeshard.diagonal_layout(xs[:D].numpy(), B, p.readahead)
            fn = timeshard.ring_stream_demod(p)
            sF, outs = fn(tables, {k: v[r:r + 1] for k, v in st.items()},
                          torch.from_numpy(ins[r]))
            res["ring"] = (_np(mesh.gather_channels(sF)),
                           _np(mesh.gather_channels(outs, dim=1)))
    finally:
        dist.destroy_process_group()
    (work / f"rank{r}_{D}.pkl").write_bytes(pickle.dumps(res))


def jax_main(work: Path):
    """The JAX side: the fleet's checkpoint first (the ranks wait for
    it), then the unsharded run_chunks from it and sharded_demod_step on
    a 2-device mesh (the port's D)."""
    import jax
    import jax.numpy as jnp
    from leansdr_tpu.dsp import receiver as J
    from leansdr_tpu.dsp.cstln import Predef as JPredef
    from leansdr_tpu.dsp.cstln import make_dvbs2_constellation as jcst
    from leansdr_tpu.parallel import mesh as jmesh
    from leansdr_tpu.pipelines.dvbs_rx import RxConfig as JRxConfig
    from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver as JRx

    x = _demod_inputs()
    rx = JRx(JRxConfig(**FLEET), C, use_pallas=False, chunk_samples=READ)
    rx.process(x[:, :READ])
    blob = rx.save_state()
    tmp = work / "ckpt.tmp"
    tmp.write_bytes(blob)
    os.replace(tmp, work / "ckpt.pkl")
    at = READ - rx.sample_backlog.shape[1]
    p = J.ReceiverParams(**PARAMS)
    assert p == rx.params, (p, rx.params)
    tables = J.make_tables(jcst(JPredef.QPSK, "1/2"))
    xs = jnp.asarray(x[:, at:at + N + 1] * 75)
    st, out = J.run_chunks(p, tables, rx.state, xs)
    _, _, mer = jmesh.sharded_demod_step(
        p, jmesh.make_channel_mesh(jax.devices()[:2]))(tables, rx.state, xs)
    res = {"state": {k: np.asarray(v) for k, v in st.items()},
           "out": {k: np.asarray(v) for k, v in out.items()},
           "mean_mer": float(mer)}
    (work / "jax.pkl").write_bytes(pickle.dumps(res))


def _start(args, work, env=None):
    return subprocess.Popen([sys.executable, __file__, *map(str, args)],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the JAX child and the rank children; call it with a name
    ("jax", "rank0_2", ...) to wait for that child and load its results.
    Children still running at the end are killed."""
    work = tmp_path_factory.mktemp("parallel")
    path = os.pathsep.join([str(REPO)] + [p for p in [
        os.environ.get("PYTHONPATH")] if p])
    env_j = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                 XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}")
    env_r = dict(os.environ, PYTHONPATH=path)
    procs = {"jax": _start(["jax", work], work, env_j)}
    for D in (2, 4):
        for r in range(D):
            procs[f"rank{r}_{D}"] = _start(["rank", r, D, work], work, env_r)
    got = {}

    def result(name):
        if name not in got:
            p = procs[name]
            try:
                log = p.communicate(timeout=JOIN_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
                pytest.fail(f"{name} still running after "
                            f"{JOIN_TIMEOUT_S} s: {log[-3000:]}")
            assert p.returncode == 0, log.decode(errors="replace")[-3000:]
            got[name] = pickle.loads((work / f"{name}.pkl").read_bytes())
        return got[name]
    result.work = work
    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port's unsharded run_chunks over all C carriers from the
    converted JAX checkpoint (computed while the ranks run)."""
    st, at = _ckpt_state(_wait_for(runs.work / "ckpt.pkl", JOIN_TIMEOUT_S))
    p = T.ReceiverParams(**PARAMS)
    tables = T.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                           "cpu")
    xs = torch.from_numpy(_demod_inputs()[:, at:at + N + 1] * 75)
    s1, o1 = T.run_chunks(p, tables, st, xs)
    return _np(s1), _np(o1)


@pytest.mark.parametrize("D", [2, 4])
def test_halo_sharded_fir(D, runs):
    x, coeffs = _fir_inputs()
    y = np.concatenate([runs(f"rank{r}_{D}")["halo"] for r in range(D)], 1)
    whole = fir_kernel.fir_ref(torch.from_numpy(_planes(x)),
                               torch.from_numpy(coeffs.astype(np.float32)))
    np.testing.assert_array_equal(y, whole.numpy())
    ref = np.convolve(x.astype(np.complex128), coeffs)[:len(x)]
    yc = y[0] + 1j * y[1].astype(np.float64)
    bar = HALO_BAR * np.abs(ref).max()
    assert np.abs(yc - ref).max() < bar

    import jax
    import jax.numpy as jnp
    from leansdr_tpu.parallel import halo as jhalo
    fj = jhalo.sharded_fir(coeffs, jhalo.make_time_mesh(jax.devices()))
    yj = np.asarray(fj(jnp.asarray(x)))
    assert np.abs(yc - yj).max() < bar


def _assert_float_state(want: dict, got: dict, tag: str):
    for k in ("mu", "freqw", "agc_gain", "est_insp"):
        a, b = want[k].astype(np.float64), got[k].astype(np.float64)
        assert (np.abs(a - b) < np.maximum(1e-3, 1e-4 * np.abs(a))).all(), \
            (tag, k)
    np.testing.assert_array_equal(got["meas_count"], want["meas_count"])


def test_mesh_from_jax_checkpoint_matches_unsharded_and_jax(runs,
                                                            unsharded):
    s1, o1 = unsharded
    s2, o2, mer = runs("rank0_2")["mesh"]
    assert runs("rank1_2")["mesh"][2] == mer        # every rank's mean
    for k in s1:
        np.testing.assert_array_equal(s2[k], s1[k], err_msg=k)
    for k in o1:
        np.testing.assert_array_equal(o2[k], o1[k], err_msg=k)
    j = runs("jax")
    assert o1["valid"].sum() > C * N // 3
    np.testing.assert_array_equal(o2["valid"], j["out"]["valid"])
    np.testing.assert_array_equal(o2["symbol"], j["out"]["symbol"])
    _assert_float_state(j["state"], s2, "mesh")
    assert abs(mer - j["mean_mer"]) <= MER_RTOL * abs(j["mean_mer"])
    assert abs(mer - o1["mer"].mean()) <= MER_RTOL * abs(mer)


def test_ring_matches_unsharded_and_jax(runs, unsharded):
    D = 2
    s1, o1 = unsharded
    sF, outs = runs("rank0_2")["ring"]
    j = runs("jax")["out"]
    for k, v in outs.items():              # [S, D, ...] superstep-major
        u = timeshard.undiagonal(v, D)     # [D, S, ...]
        if k in ("symbol", "valid", "cost"):
            u = u.reshape(D, -1)
            np.testing.assert_array_equal(u, o1[k][:D, :N], err_msg=k)
            if k != "cost":
                np.testing.assert_array_equal(u, j[k][:D, :N], err_msg=k)
        else:                               # per chunk: [D, S, 1, K...]
            u = u.reshape((D, -1) + v.shape[3:])
            np.testing.assert_array_equal(u, o1[k][:D], err_msg=k)
    for k in s1:                            # stream j ends on rank (j+S)%D
        np.testing.assert_array_equal(sF[k], s1[k][:D], err_msg=k)


def test_diagonal_layout_matches_jax():
    from leansdr_tpu.parallel import timeshard as jts
    D = 8
    x = np.random.default_rng(1).standard_normal(
        (D, 5 * 300 + 7, 2)).astype(np.float32)
    ins = timeshard.diagonal_layout(x, 300, 7)
    np.testing.assert_array_equal(ins, jts.diagonal_layout(x, 300, 7))
    outs = np.random.default_rng(2).standard_normal((5, D, 3))
    np.testing.assert_array_equal(timeshard.undiagonal(outs, D),
                                  jts.undiagonal(outs, D))


def test_one_rank_group(tmp_path):
    """World size 1 in this process: the hop is the identity (no send to
    oneself), the halo's left edge is zeros, shard and gather are the
    identity; the ring equals the unsharded run."""
    group.init(0, 1, f"file://{tmp_path / 'store'}", "gloo", "cpu")
    try:
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert group.shift([t])[0] is t
        assert not group.shift([t], wrap=False)[0].any()
        torch.testing.assert_close(mesh.shard_channels({"a": t})["a"], t)
        torch.testing.assert_close(mesh.gather_channels({"a": t})["a"], t)
        x, coeffs = _fir_inputs()
        xp = torch.from_numpy(_planes(x[:4096]))
        torch.testing.assert_close(
            halo.sharded_fir(coeffs)(xp),
            fir_kernel.fir_ref(xp, torch.from_numpy(
                coeffs.astype(np.float32))), rtol=0, atol=0)
        p = T.ReceiverParams(**PARAMS)
        tables = T.make_tables(make_dvbs2_constellation(Predef.QPSK, "1/2"),
                               "cpu")
        xs = torch.from_numpy(_demod_inputs()[:1, :2 * T.CHUNK + 1] * 75)
        s1, o1 = T.run_chunks(p, tables, T.init_state(p, 1, "cpu"), xs)
        ins = timeshard.diagonal_layout(xs.numpy(), T.CHUNK, 1)
        sF, outs = timeshard.ring_stream_demod(p)(
            tables, T.init_state(p, 1, "cpu"), torch.from_numpy(ins[0]))
        np.testing.assert_array_equal(
            outs["symbol"].reshape(1, -1).numpy(),
            o1["symbol"][:, :2 * T.CHUNK].numpy())
        for k in s1:
            torch.testing.assert_close(sF[k], s1[k], rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


def test_shard_channels_splits_evenly(monkeypatch):
    monkeypatch.setattr(group, "size", lambda g=None: 4)
    monkeypatch.setattr(group, "rank", lambda g=None: 2)
    tree = {"a": torch.arange(8), "b": (torch.arange(16).reshape(8, 2),)}
    got = mesh.shard_channels(tree)
    assert got["a"].tolist() == [4, 5]
    assert got["b"][0].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="split 4 ways"):
        mesh.shard_channels({"a": torch.zeros(6)})


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    """NCCL with two ranks on one card raises before
    init_process_group, naming the card; NCCL on the CPU raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="H100.*gloo|gloo.*H100"):
        group.init(1, 2, "tcp://127.0.0.1:1", "nccl")
    with pytest.raises(ValueError, match="gloo"):
        group.init(0, 2, "tcp://127.0.0.1:1", "nccl", device="cpu")
    assert not called
    assert group.rank_device(3) == torch.device("cuda", 0)
    assert group.rank_device(1, "cpu") == torch.device("cpu")


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "jax":
        jax_main(Path(sys.argv[2]))
    else:                                  # rank R D WORK
        rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
