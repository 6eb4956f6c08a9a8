"""The port's hard-decision fleet (MultiDvbsReceiver with viterbi=False:
the demod, the ring and fec/deconv_device.deconv_decode) against the
JAX fleet with its Pallas demod in interpret mode (use_pallas=True,
viterbi=False), on 2-channel stimuli, chunks of 4096 samples:

  rate 1/2, 4 Msps, fastlock, sampler "rrc" and sampler "linear"
  rate 3/4, 4 Msps, fastlock, "rrc"
  rate 1/2, 2.4 Msps, no fastlock, "rrc", the Python byte backend,
      offsets the carrier loop pulls in, and channel 0 rotated by 90
      degrees: the framer finds no sync, calls the decoder's next_sync,
      and the next decodes use sync map 1. Its framer starts two
      bit-phase sweeps into its third (the state a long search reaches),
      so the resync comes after one search window instead of 24. The same stream through submit() gives what
      process() gives; a JAX checkpoint after 5 chunks (the Python
      backend's blob, locked already rotated) resumes in the port.
  rate 7/8, 2.4 Msps, fastlock, "linear": a JAX checkpoint after 8
      chunks, converted, resumed in the port for 3 chunks.

The JAX side runs in one child process with multiply-add contraction
off (as tests/test_torch_dvbs_rx.py explains), started when the module's
first test asks for it, while the port runs here.

Tolerance: none. The packed fetch buffer of every chunk (decoded bytes,
disagreement counts, underflow flags, ring fill), the decode shapes, the
TS packets and the locked hypotheses are equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from leansdr_tpu.pipelines import dvbs_tx, tsgen

from leansdr_tpu_torch.convert import from_jax_checkpoint
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
from leansdr_tpu_torch.pipelines.multi_rx import MultiDvbsReceiver
from test_torch_dvbs_rx import FMA_OFF, REPO

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

C = 2
CHUNK = 4096
BASE = dict(Fm=2e6, float_scale=75, exact_lut=False, viterbi=False)
RUNS = {
    "1/2 rrc": dict(stim="1/2 4M", chunks=5, cfg=dict(
        Fs=4e6, rate="1/2", fastlock=True, sampler="rrc")),
    "1/2 linear": dict(stim="1/2 4M", chunks=5, cfg=dict(
        Fs=4e6, rate="1/2", fastlock=True, sampler="linear")),
    "3/4 rrc": dict(stim="3/4 4M", chunks=5, cfg=dict(
        Fs=4e6, rate="3/4", fastlock=True, sampler="rrc")),
    "1/2 resync": dict(stim="1/2 2.4M rot", chunks=7, warm=5, native=False,
                       preset=(0,), cfg=dict(
                           Fs=2.4e6, rate="1/2", fastlock=False,
                           sampler="rrc")),
    "7/8 checkpoint": dict(stim="7/8 2.4M", chunks=11, warm=8, cfg=dict(
        Fs=2.4e6, rate="7/8", fastlock=True, sampler="linear")),
}


def _stimulus(name):
    """[2, n, 2] float32 (unit amplitude). "4M": the modulator's 2 sps,
    delayed by 0.3 / 0.6 samples; "2.4M": 1.2 sps (x6, every 10th from
    sample 3 / 6). Carrier offsets 2e-5 / -3e-5 cycles per sample; "rot"
    turns channel 0 by 90 degrees, with offsets 5e-3 / -5e-3."""
    rate, fs = name.split()[:2]
    npkt = 28 if fs == "4M" else 60
    out = []
    for c in range(C):
        q = dvbs_tx.modulate(tsgen.generate(npkt, start=500 * c),
                             dvbs_tx.TxConfig(rate=rate, interp=2))
        z = q[:, 0] + 1j * q[:, 1]
        if fs == "4M":
            d = (0.3, 0.6)[c]
            z = (1 - d) * z[:-1] + d * z[1:]
        else:
            z = resample_poly(z, 6, 1)[3 * (c + 1)::10]
        f = (2e-5, -3e-5)[c]
        if name.endswith("rot"):
            # A quadrant off on channel 0, and offsets the carrier loop
            # pulls in over the first chunk, at a pace its gain
            # (pll_adjustment) sets.
            z = z * (1j if c == 0 else 1)
            f = (5e-3, -5e-3)[c]
        z = z * np.exp(2j * np.pi * f * np.arange(len(z)))
        out.append(np.stack([z.real, z.imag], -1))
    n = min(map(len, out))
    return np.stack([q[:n] for q in out]).astype(np.float32)


def _blocks(run):
    x = _stimulus(run["stim"])
    assert x.shape[1] >= run["chunks"] * CHUNK, x.shape
    return [x[:, k * CHUNK:(k + 1) * CHUNK] for k in range(run["chunks"])]


def _preset(rx, chans):
    """Two sweeps of the non-fastlock search done, the third at its last
    bit phase: the next failed window calls next_sync."""
    for c in chans:
        rx.backend.mpeg[c].next_sync_count = 2
        rx.backend.mpeg[c].bitphase = 7


# ------------------------------------------------------- the JAX side

def jax_runs():
    """Every run of RUNS through the JAX fleet: per chunk (packed buffer,
    decode shapes, TS per channel), the final locked hypotheses, and for
    a run with `warm` its checkpoint after that many chunks."""
    from leansdr_tpu.pipelines.dvbs_rx import RxConfig as JaxRxConfig
    from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver as JaxRx
    out = {}
    for name, run in RUNS.items():
        j = JaxRx(JaxRxConfig(**BASE, **run["cfg"]), C, use_pallas=True,
                  chunk_samples=CHUNK, native=run.get("native"))
        _preset(j, run.get("preset", ()))
        recs, blob = [], None
        for k, blk in enumerate(_blocks(run)):
            if k == run.get("warm"):
                blob = j.save_state()
            pend = j.dispatch(blk)
            recs.append(None if pend is None else
                        (np.asarray(pend[0]), pend[1], j.collect(pend)))
        out[name] = dict(recs=recs, blob=blob, backend=type(j.backend)
                         .__name__, locked=np.asarray(j.deconv.state[
                             "locked"]), locks=list(j.locks))
    return out


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """The JAX results, computed in a child process started at the first
    request; call it to wait for them."""
    tmp = tmp_path_factory.mktemp("jax_hard_fleet")
    dst = tmp / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(dst)], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    got = {}

    def result():
        if not got:
            log = proc.communicate(timeout=1200)[0].decode(errors="replace")
            assert proc.returncode == 0, log[-3000:]
            got.update(pickle.loads(dst.read_bytes()))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ------------------------------------------------------------ the port

def _port(run, **kw):
    rx = MultiDvbsReceiver(RxConfig(**BASE, **run["cfg"]), C,
                           chunk_samples=CHUNK, native=run.get("native"),
                           device="cpu", **kw)
    _preset(rx, run.get("preset", ()))
    return rx


def _port_run(rx, blocks):
    recs = []
    for blk in blocks:
        pend = rx.dispatch(blk)
        recs.append(None if pend is None else
                    (pend[0].numpy(), pend[1], rx.collect(pend)))
    return recs


def _assert_same(want, got, name):
    decodes = 0
    for k, (a, b) in enumerate(zip(want, got, strict=True)):
        assert (a is None) == (b is None), f"{name} chunk {k}: dispatch"
        if a is None:
            continue
        assert a[1] == b[1], f"{name} chunk {k}: decode shapes differ"
        assert a[0].shape == b[0].shape, f"{name} chunk {k}"
        bad = np.argwhere(a[0] != b[0])
        assert not len(bad), (
            f"{name} chunk {k}: {len(bad)} bytes differ, first at channel "
            f"{bad[0][0]} byte {bad[0][1]}")
        for c in range(C):
            np.testing.assert_array_equal(a[2][c], b[2][c],
                                          err_msg=f"{name} chunk {k} TS")
        decodes += len(b[1])
    return decodes


def test_hard_fleet_resync_matches_jax_and_submit(jax):
    """No fastlock, channel 0 a quadrant off: the framer's next_sync
    reaches the decoder (JAX wires it the same way), locked becomes
    [1, 0], and the decodes after it use map 1; the Python byte backend
    on both sides. Then the same stream through submit()/flush(): the
    resync lands at the same dispatch, so the TS, the ring, the locked
    hypotheses and the byte backend's state equal process()'s."""
    run = RUNS["1/2 resync"]
    blocks = _blocks(run)
    rx = _port(run)
    assert type(rx.backend).__name__ == "_ByteBackend"
    got = _port_run(rx, blocks)
    want = jax()["1/2 resync"]
    assert want["backend"] == "_ByteBackend"
    _assert_same(want["recs"], got, "resync")
    np.testing.assert_array_equal(want["locked"],
                                  rx.deconv.state["locked"].numpy())
    assert rx.deconv.state["locked"].tolist() == [1, 0]
    # A decode ran after the resync was applied.
    assert got[-1] is not None and got[-1][1]

    piped = _port(run)
    done = []
    for blk in blocks:
        done += piped.submit(blk)
    done += piped.flush()
    piped.close()
    seq = [r[2] for r in got if r is not None]
    assert len(done) == len(seq)
    for a, b in zip(seq, done):
        for c in range(C):
            np.testing.assert_array_equal(a[c], b[c])
    for k in ("buf", "fill", "locked"):
        assert torch.equal(rx.deconv.state[k], piped.deconv.state[k]), k
    sa, sb = (pickle.loads(r.backend.save_blob()) for r in (rx, piped))
    assert sa["mpeg"] == sb["mpeg"]
    for c in range(C):
        for k in ("byte_backlog", "mpegbyte_backlog"):
            np.testing.assert_array_equal(sa[k][c], sb[k][c])

    # The JAX checkpoint after chunk 5 (backend_native "_ByteBackend"),
    # converted: the last two chunks as JAX decoded them; the port's own
    # round trip of it carries the Python backend's state.
    d = pickle.loads(want["blob"])
    assert d["backend_native"] == "_ByteBackend"
    assert d["deconv_state"]["locked"].tolist() == [1, 0]
    resumed = _port(run)
    resumed.load_state(from_jax_checkpoint(want["blob"]))
    again = _port(run)
    again.load_state(resumed.save_state())
    assert again.backend.save_blob() == resumed.backend.save_blob()
    _assert_same(want["recs"][5:], _port_run(resumed, blocks[5:]),
                 "resync checkpoint")


@pytest.mark.parametrize("name", ["1/2 rrc", "1/2 linear", "3/4 rrc"])
def test_hard_fleet_cold_start_matches_jax(name, jax):
    """5 chunks from cold, fastlock: packed buffers and TS equal chunk by
    chunk, locked hypotheses equal; the linear sampler reads the input
    with no matched filter (readahead = the sampler's alone)."""
    run = RUNS[name]
    rx = _port(run)
    assert (rx.mf_taps is None) == (run["cfg"]["sampler"] == "linear")
    assert rx.deconv.kind == "deconv" and rx.params.pll_adjustment == 1.0
    got = _port_run(rx, _blocks(run))
    want = jax()[name]
    assert _assert_same(want["recs"], got, name) >= 2
    np.testing.assert_array_equal(want["locked"],
                                  rx.deconv.state["locked"].numpy())


def test_hard_fleet_jax_checkpoint_resumes(jax):
    """A JAX hard-decision fleet checkpoint (ring buf/fill/locked, the
    host fill estimate, the C++ backend's blob) after 8 chunks, carried
    in by convert.from_jax_checkpoint: the port then gives JAX's packed
    buffers and TS for the next 3 chunks, with packets out; the port's
    own save_state/load_state round trip gives the same first chunk."""
    run = RUNS["7/8 checkpoint"]
    want = jax()["7/8 checkpoint"]
    blocks = _blocks(run)[run["warm"]:]
    rx = _port(run)
    rx.load_state(from_jax_checkpoint(want["blob"], rate="7/8"))
    d = pickle.loads(want["blob"])
    assert set(d["deconv_state"]) == {"buf", "fill", "locked"}
    assert rx.deconv._est_fill == d["deconv_host"]["_est_fill"]
    again = _port(run)
    again.load_state(rx.save_state())
    got = _port_run(rx, blocks)
    _assert_same(want["recs"][run["warm"]:], got, "checkpoint")
    assert sum(len(r[2][c]) for r in got if r for c in range(C)) > 0
    assert rx.locks == want["locks"]
    _assert_same(got[:1], _port_run(again, blocks[:1]), "round trip")


if __name__ == "__main__":
    # The JAX side: python test_torch_hard_fleet.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(jax_runs()))
