"""Every constellation and code rate of the port (ROADMAP queue 1 item 20)
against the JAX package on the CPU:

  * `make_sync_maps` (and the constellations it maps) for every
    (constellation, rate) the CLIs accept, or the same error;
  * the banked ACS's plain version (`viterbi_acs_banked_ref`, the twin
    of csrc/acs_banked.cu) at the three trellis rates new to it (1/2 on
    the banked route, B=1; 2/3, B=2; 4/5, B=4 with its own polynomials)
    against JAX's NumPy model `acs_block_np` and its XLA scan
    `_viterbi_chunk_device`, from a live state, with ties and at BPSK's
    int16-sum cost extremes;
  * the single carrier's `ViterbiSyncDevice` and the fleet's
    `MultiViterbiSync` at 8PSK 2/3, BPSK 1/2, 32APSK 4/5 and 16APSK 3/4
    on a coded stream sent under another sync than the first;
  * `DvbsReceiver` at 8PSK 2/3 and `MultiDvbsReceiver` at 32APSK 4/5 end
    to end (the scan demod with the exact LUT, JAX's CPU route, on both
    sides), the JAX side in a child process with FMA contraction off
    while the port runs;
  * hard decisions on constellations other than QPSK, which the JAX
    package decodes with QPSK's 4 sync maps: the single carrier's host
    deconvolver raises IndexError on a symbol past 3, the fleet's device
    decode reads it as IQ bits 0; BPSK decodes;
  * the combinations the JAX receivers refuse raise the same error.

Tolerance: none. Sync maps, ACS planes, us/q, bytes and TS packets are
integers and must be equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.fec import deconv_device as tdd
from leansdr_tpu_torch.fec import viterbi as tvit
from leansdr_tpu_torch.fec import viterbi_banked as tvb
from leansdr_tpu_torch.fec import viterbi_device as tvd
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.pipelines import multi_rx as TM

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# The JAX side of the end-to-end runs: XLA with multiply-add contraction
# off (no FMA instructions), so its demod rounds each float operation as
# the port's plain versions do (tests/test_torch_dvbs_rx.py).
FMA_OFF = "--xla_cpu_max_isa=AVX"
CODE_RATES = ("1/2", "2/3", "3/4", "4/6", "5/6", "7/8", "4/5")
# (constellation, DVB-S code rate) of the decoder tests.
CASES = (("PSK8", "2/3"), ("BPSK", "1/2"), ("APSK32", "4/5"),
         ("APSK16", "3/4"))
# End to end: (constellation, rate, samples per carrier); the stimulus
# is the JAX modulator's 2 samples per symbol, at 1 Msym/s, resampled x4
# and read with a per-carrier delay of 1 (+c) quarter samples.
E2E_SINGLE = ("PSK8", "2/3", 32768)
E2E_FLEET = ("APSK32", "4/5", 32768, 2)


def _outcome(fn):
    """fn()'s result, or (exception type name, message)."""
    try:
        return fn()
    except Exception as e:                  # noqa: BLE001 - compared below
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", [p.name for p in Predef
                                  if p.name not in ("QAM1024",)])
def test_sync_maps_match_jax(name):
    """For every code rate: the constellation's symbols and LUT, and
    make_sync_maps' maps, nconj, nrot and nshifts equal JAX's, or both
    raise the same error; the fleet's route (banked unless 4 maps with
    one symbol per block) is JAX's."""
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.fec import viterbi as jv
    for rate in CODE_RATES:
        def jax_side():
            c = jc.make_dvbs2_constellation(jc.Predef[name], rate)
            return c, jv.make_sync_maps(c, rate)

        def port_side():
            c = make_dvbs2_constellation(Predef[name], rate)
            return c, tvit.make_sync_maps(c, rate)
        j, t = _outcome(jax_side), _outcome(port_side)
        if isinstance(j[0], str):
            assert t == j, (name, rate)
            continue
        assert not isinstance(t[0], str), (name, rate, t)
        (jcs, (jm, *jn)), (tcs, (tm, *tn)) = j, t
        np.testing.assert_array_equal(jcs.symbols, tcs.symbols)
        np.testing.assert_array_equal(jcs.lut_symbol, tcs.lut_symbol)
        np.testing.assert_array_equal(jm, tm, err_msg=f"{name} {rate}")
        assert jn == tn
        nconj, nrot, nshifts = tn
        banked = not (nconj * nrot == tvd.NSYNCS and nshifts == 1)
        if banked:
            assert rate in tvb.BANKED_RATES
            tvb.bank_geometry(rate)


def _tie_inputs(rate, T, N, seed, nshifts=0):
    """Random block symbols and costs: 0, -3, -6 or -9 (metric ties), or
    with nshifts the sum of nshifts symbols' costs at the int16 extremes
    (-2^15, 2^15 - 1, 0 or between)."""
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, tvit.make_trellis(rate).ncs, (T, N)).astype(
        np.int32)
    if not nshifts:
        return cs, -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    cost = np.zeros((T, N), np.int64)
    for _ in range(nshifts):
        pick = rng.integers(0, 4, (T, N))
        cost += np.where(pick == 0, -(1 << 15), np.where(
            pick == 1, (1 << 15) - 1, np.where(
                pick == 2, 0, rng.integers(-(1 << 15), 1 << 15, (T, N)))))
    return cs, cost.astype(np.int32)


def _twin(rate, cs, cost, planes=None):
    N = cs.shape[1]
    z = torch.zeros((64, N), dtype=torch.int32)
    return tvb.viterbi_acs_banked(rate, *(planes or (z, z, z)),
                                  torch.from_numpy(cs),
                                  torch.from_numpy(cost))


@pytest.mark.parametrize("rate", ["1/2", "2/3", "4/5"])
def test_banked_twin_matches_jax(rate):
    """viterbi_acs_banked_ref from a live state (the end of a first run)
    against JAX's acs_block_np block by block (T=64, N=8, ties) and its
    XLA scan (T=512, N=8: ties, then BPSK's int16-sum extremes, nshifts
    = bits_out symbols per block): metric, 64-bit paths, us and q equal
    bit for bit."""
    import jax.numpy as jnp
    from leansdr_tpu.fec import viterbi as jv
    from leansdr_tpu.fec import viterbi_banked as jvb
    geo = tvb.bank_geometry(rate)
    start = _twin(rate, *_tie_inputs(rate, 256, 8, seed=1))[:3]

    cs, cost = _tie_inputs(rate, 64, 8, seed=2)
    got = _twin(rate, cs, cost, start)
    jgeo = jvb.bank_geometry(rate)
    m, hi, lo = (p.numpy().astype(np.int64) for p in start)
    hi, lo = hi & 0xFFFFFFFF, lo & 0xFFFFFFFF
    for t in range(64):
        m, hi, lo, us, q = jvb.acs_block_np(jgeo, m, hi, lo,
                                            cs[t].astype(np.int64),
                                            cost[t].astype(np.int64))
        np.testing.assert_array_equal(us, got[3][t].numpy(), err_msg=f"us {t}")
        np.testing.assert_array_equal(q, got[4][t].numpy(), err_msg=f"q {t}")
    for name, a, b, mask in (("metric", m, got[0], -1),
                             ("hi", hi, got[1], 0xFFFFFFFF),
                             ("lo", lo, got[2], 0xFFFFFFFF)):
        np.testing.assert_array_equal(a, b.numpy().astype(np.int64) & mask,
                                      err_msg=name)

    bits_out = tvit.make_trellis(rate).bits_out
    for seed, nshifts in ((3, 0), (4, bits_out)):
        cs, cost = _tie_inputs(rate, 512, 8, seed, nshifts)
        got = _twin(rate, cs, cost, start)
        nat = [p.numpy()[geo.rho].T for p in start]       # [S, 64]
        want = jv._viterbi_chunk_device(
            rate, jnp.asarray(nat[0]), jnp.asarray(nat[1].view(np.uint32)),
            jnp.asarray(nat[2].view(np.uint32)), jnp.asarray(cs.T),
            jnp.asarray(cost.T))
        want = [np.asarray(a).view(np.int32).T[geo.orig]
                for a in want[:3]] + [np.asarray(a).T for a in want[3:]]
        for name, a, b in zip(("metric", "hi", "lo", "us", "q"), want, got):
            np.testing.assert_array_equal(a, b.numpy(),
                                          err_msg=f"{name} seed {seed}")
        start = got[:3]


def _coded_symbols(name, rate, nsym, sync, seed):
    """A coded stream of `nsym` constellation symbols at trellis rate
    `rate` (random data), sent under sync map `sync % nmaps` and
    `sync // nmaps` symbols late, with 1% symbol errors; and int16 soft
    costs (worse on the errors)."""
    from leansdr_tpu.fec import convenc
    cst = make_dvbs2_constellation(Predef[name], rate)
    maps, nconj, nrot, nshifts = tvit.make_sync_maps(cst, rate)
    rng = np.random.default_rng(seed)
    bits_in, bits_out = convenc.FEC_SPECS[rate]
    nbytes = (nsym * cst.bits_per_symbol * bits_in // bits_out // 8
              // bits_in + 2) * bits_in
    data = rng.integers(0, 256, nbytes, dtype=np.uint8)
    cs, _ = convenc.encode(data, rate, cst.bits_per_symbol)
    m, late = sync % len(maps), sync // len(maps)
    syms = np.zeros(nsym, np.uint8)
    syms[late:] = np.argsort(maps[m])[cs[:nsym - late]]
    bad = rng.random(nsym) < 0.01
    syms[bad] = rng.integers(0, cst.nsymbols, int(bad.sum()))
    costs = np.where(bad, -rng.integers(1, 40, nsym),
                     -rng.integers(20, 120, nsym)).astype(np.int16)
    return syms, costs


@pytest.mark.parametrize("name,rate", CASES)
def test_viterbi_sync_device_matches_jax(name, rate):
    """The single carrier's ViterbiSyncDevice (csrc/acs.cu's plain
    version at rate 1/2, 2 lanes for BPSK; the banked twin otherwise, at
    the trellis rate the receiver picks: 8PSK keeps 2/3) against JAX's
    on the same coded stream sent under the last sync, fed in three
    uneven pieces: bytes, the elected sync (not the first) and the
    backlog equal."""
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.fec import viterbi as jv
    cst = make_dvbs2_constellation(Predef[name], rate)
    vrate = tvb.viterbi_rate(rate, cst.nsymbols)
    t = tvit.ViterbiSyncDevice(cst, vrate, fastlock=True, device="cpu")
    j = jv.ViterbiSyncDevice(jc.make_dvbs2_constellation(jc.Predef[name],
                                                         rate), vrate,
                             fastlock=True)
    assert (t.nsyncs, t.nshifts) == (j.nsyncs, j.nshifts)
    nsym = 128 * t.nshifts * 9 + 77
    syms, costs = _coded_symbols(name, vrate, nsym, t.nsyncs - 1, seed=7)
    got, want = [], []
    for lo, hi in ((0, 1000), (1000, 2500), (2500, nsym)):
        got.append(t.process(syms[lo:hi], costs[lo:hi]))
        want.append(j.process(syms[lo:hi], costs[lo:hi]))
    np.testing.assert_array_equal(np.concatenate(want), np.concatenate(got))
    assert t.current == j.current != 0        # the election moved
    np.testing.assert_array_equal(j.sym_backlog, t.sym_backlog)
    assert t.plane_keys == (("metric", "path") if vrate == "1/2"
                            else ("metric", "path_hi", "path_lo"))


@pytest.mark.parametrize("name,rate", CASES)
def test_multi_viterbi_sync_matches_jax(name, rate):
    """The fleet's MultiViterbiSync at the fleet's trellis rate (8PSK 2/3
    as 4/6: 32 replicas; BPSK 1/2 on the banked route, B=1) against the
    JAX fleet decoder's XLA scan (its CPU route, ACQUIRE only), two
    carriers sent under different syncs, two decodes: bytes,
    discriminants with the election, underflow, the elected syncs and
    the trellis planes (JAX's [S, 64] natural order to stored rows)."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.fec import viterbi_device as jvd
    frate = tvb.fleet_rate(rate)
    C = 2
    cst = make_dvbs2_constellation(Predef[name], frate)
    a = jvd.MultiViterbiSync(jc.make_dvbs2_constellation(jc.Predef[name],
                                                         frate),
                             frate, C, 1 << 12, 2.0, banked=False)
    b = tvd.MultiViterbiSync(cst, frate, C, 1 << 12, 2.0, device="cpu")
    assert a.xla and b.kind == "viterbi_banked"
    assert b.plan.nsyncs == a.plan.nsyncs and b.plan.E == a.plan.E
    n = 2 * a.plan.consumed + a.plan.nshifts
    syms = np.zeros((n, C), np.uint8)
    costs = np.zeros((n, C), np.int16)
    for c, sync in enumerate((b.plan.nsyncs - 1, b.plan.nsyncs // 2 + 1)):
        syms[:, c], costs[:, c] = _coded_symbols(name, frate, n, sync,
                                                 seed=11 + c)
    valid = np.ones((n, C), bool)
    for it, (lo, hi) in enumerate(((0, n // 2 + 3), (n // 2 + 3, n))):
        a.append(jnp.asarray(syms[lo:hi]), jnp.asarray(valid[lo:hi]),
                 jnp.asarray(costs[lo:hi]))
        b.append(torch.from_numpy(syms[lo:hi]),
                 torch.from_numpy(valid[lo:hi]),
                 torch.from_numpy(costs[lo:hi]))
        out_a, out_b = a.decode(), b.decode()
        for nm, x, y in zip(("bytes", "discr", "under"), out_a, out_b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f"{nm}, decode {it}")
    orig = tvb.bank_geometry(frate).orig
    for k in ("metric", "path_hi", "path_lo"):
        want = np.asarray(a.state[k]).view(np.int32).T[orig]
        np.testing.assert_array_equal(want, b.state[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(a.state["current"]),
                                  b.state["current"].numpy())


# --------------------------------------------------------------- end to end

def _e2e_stimulus(name, rate, n, C):
    """[C, n, 2] float32: carrier c the JAX modulator's TS packets from
    1000*c at 2 samples per symbol, x4 and read from quarter sample 1+c
    (a fractional delay) every 4th, i.e. 2 samples per symbol."""
    from scipy.signal import resample_poly
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_tx, tsgen
    rows = []
    for c in range(C):
        iq = dvbs_tx.modulate(tsgen.generate(80, start=1000 * c),
                              dvbs_tx.TxConfig(constellation=JP[name],
                                               rate=rate, interp=2))
        z = resample_poly(iq[:, 0] + 1j * iq[:, 1], 4, 1)[1 + c::4][:n]
        rows.append(np.stack([z.real, z.imag], -1).astype(np.float32))
    return np.stack(rows)


def _e2e_cfg(name, rate):
    return dict(Fs=2e6, Fm=1e6, rate=rate, viterbi=True, fastlock=True,
                anf=0, float_scale=75, exact_lut=True)


def _jax_e2e():
    """The JAX side of both end-to-end runs (in the child process)."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    from leansdr_tpu.pipelines import multi_rx as JMr
    name, rate, n = E2E_SINGLE
    x = _e2e_stimulus(name, rate, n, 1)[0]
    j = J.DvbsReceiver(J.RxConfig(constellation=JP[name],
                                  **_e2e_cfg(name, rate)))
    single = [j.process(x[i:i + 8192]) for i in range(0, n, 8192)]
    name, rate, n, C = E2E_FLEET
    x = _e2e_stimulus(name, rate, n, C)
    jm = JMr.MultiDvbsReceiver(J.RxConfig(constellation=JP[name],
                                          **_e2e_cfg(name, rate)), C,
                               chunk_samples=4096)
    fleet = [jm.process(x[:, i:i + 4096]) for i in range(0, n, 4096)]
    return dict(single=np.concatenate(single), single_lock=j.lock,
                fleet=[np.concatenate([o[c] for o in fleet])
                       for c in range(C)], fleet_locks=list(jm.locks))


@pytest.fixture(scope="module")
def jax_e2e(tmp_path_factory):
    """Starts the JAX end-to-end runs in a child process; returns a
    function that waits for their result."""
    dst = tmp_path_factory.mktemp("e2e") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(dst)], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)

    def result():
        out, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, out.decode()[-3000:]
        return pickle.loads(dst.read_bytes())
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_dvbs_receiver_8psk_matches_jax(jax_e2e):
    """DvbsReceiver --const 8PSK --cr 2/3 --viterbi (the 2/3 trellis on
    the banked ACS's B=2 instance, 16 replicas) end to end on the scan
    demod: locks and decodes the JAX receiver's TS packets exactly."""
    name, rate, n = E2E_SINGLE
    x = _e2e_stimulus(name, rate, n, 1)[0]
    rx = TR.DvbsReceiver(TR.RxConfig(constellation=Predef[name],
                                     **_e2e_cfg(name, rate)), device="cpu")
    assert (rx.deconv.rate, rx.deconv.nsyncs) == ("2/3", 16)
    ts = np.concatenate([rx.process(x[i:i + 8192])
                         for i in range(0, n, 8192)])
    want = jax_e2e()
    assert rx.lock and want["single_lock"]
    assert len(ts) >= 5
    np.testing.assert_array_equal(want["single"], ts)


def test_multi_receiver_32apsk_matches_jax(jax_e2e):
    """MultiDvbsReceiver with 32APSK at 4/5 (the 4/5 tables on the banked
    ACS's B=4 instance, 8 replicas per carrier), two carriers, end to
    end on the scan demod, TRACK mode off (the JAX fleet's XLA route on
    the CPU has none): the JAX fleet's TS packets and locks."""
    name, rate, n, C = E2E_FLEET
    x = _e2e_stimulus(name, rate, n, C)
    rx = TM.MultiDvbsReceiver(TR.RxConfig(constellation=Predef[name],
                                          **_e2e_cfg(name, rate)), C,
                              chunk_samples=4096, device="cpu")
    rx.deconv.track_after = 1 << 30
    assert (rx.deconv.kind, rx.deconv.plan.nsyncs) == ("viterbi_banked", 8)
    out = [rx.process(x[:, i:i + 4096]) for i in range(0, n, 4096)]
    want = jax_e2e()
    assert rx.locks == want["fleet_locks"] and rx.locks[0]
    for c in range(C):
        ts = np.concatenate([o[c] for o in out])
        np.testing.assert_array_equal(want["fleet"][c], ts, err_msg=str(c))
    assert len(want["fleet"][0]) >= 1


# ------------------------------------------------------------ hard decisions

def test_hard_decisions_non_qpsk_match_jax():
    """Without --viterbi the receivers decode every constellation with
    QPSK's 4 sync maps, as the JAX package does. The single carrier's
    host deconvolver (2/3 as 4/6) raises IndexError on an 8PSK symbol
    past 3, as JAX's does, and decodes BPSK symbols to JAX's bytes; the
    fleet's device decode reads 8PSK symbols past 3 as IQ bits 0, as
    JAX's select chain does: bytes, error counts and underflow equal."""
    import jax.numpy as jnp
    from leansdr_tpu.fec import deconv_device as jdd
    from leansdr_tpu.pipelines import dvbs_rx as J
    rng = np.random.default_rng(21)
    for nsym, syms in ((8, rng.integers(0, 8, 6000).astype(np.uint8)),
                       (2, rng.integers(0, 2, 6000).astype(np.uint8))):
        j = J._DeconvolSync("4/6", fastlock=True)
        t = TR._DeconvolSync("4/6", fastlock=True)
        jo, to = _outcome(lambda: j.process(syms)), _outcome(
            lambda: t.process(syms))
        if nsym == 8:
            assert jo[0] == to[0] == "IndexError", (jo, to)
        else:
            assert len(jo) > 0
            np.testing.assert_array_equal(jo, to)
    C = 2
    a = jdd.DeviceDeconvolver("4/6", C, 1 << 13, 2.0, fastlock=True)
    b = tdd.DeviceDeconvolver("4/6", C, 1 << 13, 2.0, fastlock=True,
                              device="cpu")
    n = a.plan.consumed + 400
    syms = rng.integers(0, 8, (n, C)).astype(np.uint8)
    valid = np.ones((n, C), bool)
    a.append(jnp.asarray(syms), jnp.asarray(valid), None)
    b.append(torch.from_numpy(syms), torch.from_numpy(valid), None)
    for nm, x, y in zip(("bytes", "errs", "under"), a.decode(), b.decode()):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=nm)
    for cfg in (dict(constellation=Predef.PSK8, rate="2/3"),
                dict(constellation=Predef.BPSK, rate="1/2")):
        rx = TR.DvbsReceiver(TR.RxConfig(exact_lut=False, **cfg),
                             device="cpu")
        assert type(rx.deconv).__name__ == "_DeconvolSync"
        assert rx.deconv.rate == tvb.fleet_rate(cfg["rate"])


# Combinations the JAX receivers refuse, and some they take.
REFUSED = ((Predef.QPSK, "4/5"), (Predef.APSK16, "1/2"),
           (Predef.PSK8, "3/4"), (Predef.PSK8, "1/2"),
           (Predef.APSK32, "2/3"), (Predef.QAM256, "1/2"),
           (Predef.PSK8, "2/3"), (Predef.APSK64E, "2/3"))


@pytest.mark.parametrize("viterbi", [False, True])
def test_refused_combinations_match_jax(viterbi):
    """DvbsReceiver and MultiDvbsReceiver raise what the JAX receivers
    raise for each combination (ValueError "Code rate not suitable for
    this constellation" from the sync maps, "Code rate not supported
    with ..." from the constellation, KeyError from the hard decoder at
    4/5), or build as they do, with the same trellis rate."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    from leansdr_tpu.pipelines import multi_rx as JMr
    for const, rate in REFUSED:
        kw = dict(Fs=4e6, Fm=2e6, rate=rate, viterbi=viterbi, anf=0)
        jc = J.RxConfig(constellation=JP[const.name], **kw)
        tc = TR.RxConfig(constellation=const, exact_lut=False, **kw)
        for jmake, tmake in (
                (lambda: J.DvbsReceiver(jc),
                 lambda: TR.DvbsReceiver(tc, device="cpu")),
                (lambda: JMr.MultiDvbsReceiver(jc, 2, chunk_samples=4096),
                 lambda: TM.MultiDvbsReceiver(tc, 2, chunk_samples=4096,
                                              device="cpu"))):
            j, t = _outcome(jmake), _outcome(tmake)
            if isinstance(j, tuple):
                assert t == j, (const.name, rate, viterbi)
                continue
            assert not isinstance(t, tuple), (const.name, rate, t)
            assert getattr(t.deconv, "rate", None) == getattr(
                j.deconv, "rate", None)


if __name__ == "__main__":          # the JAX side of the end-to-end tests
    sys.path.insert(0, str(REPO))
    Path(sys.argv[1]).write_bytes(pickle.dumps(_jax_e2e()))
