"""The port's small device helpers and the rest of the name diff against
the JAX package, on the same seeded NumPy inputs: fec/rs.py
torch_encode / torch_syndromes (jax_encode / jax_syndromes),
fec/prbs.py derandomize_scan, dsp/math_utils.py cmul / parity_u32 /
popcount_u32 / log2i, core/generic.py ItemCounter / decimate /
serialize, fec/deconv.py BatchedDeconvolSync, dsp/blocks.py adder /
scaler / naive_lowpass / SSEstimator / SSAmpEstimator,
dsp/filtergen.py dump_filter, dsp/fft.py fft.

Tolerance: none but for fft. Every other output is equal, bit for bit
(the RS products are sums of at most 1632 ones in float32, exact with
TF32 off; cmul is the same float32 expression on both sides). fft is
held as tests/test_torch_mlm.py holds fft_planes: within 2e-6 x max|y|
(float32 matmuls that sum in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leansdr_tpu.core import generic as jg
from leansdr_tpu.dsp import blocks as jb
from leansdr_tpu.dsp import fft as jfft
from leansdr_tpu.dsp import filtergen as jf
from leansdr_tpu.dsp import math_utils as jm
from leansdr_tpu.fec import deconv as jd
from leansdr_tpu.fec import prbs as jp
from leansdr_tpu.fec import rs as jrs

from leansdr_tpu_torch.core import generic as tg
from leansdr_tpu_torch.dsp import blocks as tb
from leansdr_tpu_torch.dsp import fft as tfft
from leansdr_tpu_torch.dsp import filtergen as tf
from leansdr_tpu_torch.dsp import math_utils as tm
from leansdr_tpu_torch.fec import convenc, prbs, rs
from leansdr_tpu_torch.fec import deconv as td
from leansdr_tpu_torch.pipelines import dvbs_tx_device

torch.set_num_threads(1)


def test_rs_encode_and_syndromes_match_jax():
    rng = np.random.default_rng(10)
    msgs = rng.integers(0, 256, (37, 188), dtype=np.uint8)
    bits = np.unpackbits(msgs, axis=1)
    want = np.asarray(jrs.jax_encode(jnp.asarray(bits)))
    got = rs.torch_encode(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # The parity is the host encoder's.
    np.testing.assert_array_equal(
        np.packbits(got.numpy(), axis=1), rs.encode(msgs)[:, 188:])

    pk = rs.encode(msgs)
    pk[::3, rng.integers(0, 204, 13)] ^= 0x5A          # some corrupted
    pbits = np.unpackbits(pk, axis=1)
    want = np.asarray(jrs.jax_syndromes(jnp.asarray(pbits)))
    got = rs.torch_syndromes(torch.from_numpy(pbits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1::3].any() and got[::3].any()
    # An all-ones packet: every product's sum is the row count, 1632.
    ones = np.ones((1, 1632), np.uint8)
    np.testing.assert_array_equal(
        rs.torch_syndromes(torch.from_numpy(ones)).numpy(),
        np.asarray(jrs.jax_syndromes(jnp.asarray(ones))))


def test_device_modulator_parity_is_torch_encode():
    """DeviceModulator's RS parity goes through rs.torch_encode (one
    implementation): its RS packets equal the host encoder's."""
    m = dvbs_tx_device.DeviceModulator(device="cpu")
    assert not hasattr(m, "enc_m")
    pk = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (24, 188), dtype=np.uint8))
    rand = pk ^ m.pat[torch.arange(24) % 8]
    par = rs.torch_encode(dvbs_tx_device._unpack_bits(rand))
    np.testing.assert_array_equal(
        dvbs_tx_device._pack_bits(par).numpy(),
        rs.encode(rand.numpy())[:, 188:])


def _prbs_stream(rng, n, resyncs):
    """n randomized packets from phase 3, their sync bytes at `resyncs`
    set to the inverted sync (or its corrupted marker), a few sync bytes
    hit by noise."""
    pk = rng.integers(0, 256, (n, 188), dtype=np.uint8)
    pk[:, 0] = prbs.MPEG_SYNC
    out, _ = prbs.randomize(pk, 3)
    for k, i in enumerate(resyncs):
        out[i, 0] = prbs.MPEG_SYNC_INV ^ (prbs.MPEG_SYNC_CORRUPTED
                                          if k % 2 else 0)
    out[rng.integers(0, n, 4), 0] ^= 0x10
    return out


@pytest.mark.parametrize("resyncs", [(), (5,), (0, 9, 17, 18, 30)],
                         ids=["none", "one", "many"])
def test_derandomize_scan_matches_jax(resyncs):
    rng = np.random.default_rng(12 + len(resyncs))
    pk = _prbs_stream(rng, 40, resyncs)
    for pos0 in range(8):
        o_j, g_j, n_j = jp.derandomize_scan(jnp.asarray(pk),
                                            jnp.asarray(pos0, jnp.int32))
        o_t, g_t, n_t = prbs.derandomize_scan(torch.from_numpy(pk), pos0)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        assert int(n_t) == int(n_j), (resyncs, pos0)
        # The host derandomizer's packets, where it keeps them.
        if not resyncs:
            continue
        o_h, good_h, _ = prbs.derandomize_np(pk, pos0)
        np.testing.assert_array_equal(good_h, g_t.numpy())
    o_t, g_t, n_t = prbs.derandomize_scan(
        torch.zeros((0, 188), dtype=torch.uint8), 6)
    assert o_t.shape == (0, 188) and int(n_t) == 6


def test_parity_and_popcount_match_jax():
    rng = np.random.default_rng(13)
    u = np.concatenate([
        rng.integers(0, 1 << 32, 4000, dtype=np.uint64),
        rng.integers(1 << 31, 1 << 32, 4000, dtype=np.uint64),
        [0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1,
         0x80000001, 0xAAAAAAAA, 0x55555555, 0xF0F0F0F0]]).astype(np.uint32)
    want_p = np.asarray(jm.parity_u32(jnp.asarray(u)))
    want_c = np.asarray(jm.popcount_u32(jnp.asarray(u)))
    np.testing.assert_array_equal(want_c, [bin(int(v)).count("1")
                                           for v in u])
    for t in (torch.from_numpy(u.view(np.int32)),       # two's complement
              torch.from_numpy(u.astype(np.int64))):
        p, c = tm.parity_u32(t), tm.popcount_u32(t)
        assert p.dtype == torch.uint8 and c.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), want_p)
        np.testing.assert_array_equal(c.numpy(), want_c)


def test_cmul_log2i_and_generic_blocks_match_jax():
    rng = np.random.default_rng(14)
    a = rng.standard_normal((4, 1000)).astype(np.float32)
    want = jm.cmul(*(jnp.asarray(v) for v in a))
    got = tm.cmul(*(torch.from_numpy(v) for v in a))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for x in [0, 1, 2, 3, 4, 255, 256, 1 << 40, (1 << 40) - 1]:
        assert tm.log2i(x) == jm.log2i(x)

    cj, ct = jg.ItemCounter(), tg.ItemCounter()
    for n in (0, 5, 188, 3):
        assert ct.process(np.zeros(n)) == cj.process(np.zeros(n))
    x = rng.integers(0, 255, 1001, dtype=np.uint8)
    for d in (1, 2, 7):
        np.testing.assert_array_equal(tg.decimate(x, d), jg.decimate(x, d))
    for dt in (np.uint16, np.uint32, np.complex64):
        got, want = tg.serialize(x[:1000], dt), jg.serialize(x[:1000], dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _coded(rng, n, rate, rot, slip=None):
    """A rate-`rate` coded QPSK symbol stream seen under sync map `rot`,
    with one symbol dropped at `slip` (a symbol slip)."""
    data = rng.integers(0, 256, n // 4, dtype=np.uint8)
    cs, _ = convenc.encode(data, rate, 2)
    syms = np.argsort(td.sync_maps()[rot])[cs].astype(np.uint8)
    return np.delete(syms, slip) if slip is not None else syms


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_batched_deconvol_sync_matches_jax(rate):
    """Three channels under different syncs, one with a symbol slip, fed
    in uneven pieces: every call's bytes, the locked hypotheses and the
    backlogs equal the JAX batcher's."""
    rng = np.random.default_rng(15)
    streams = [_coded(rng, 30000, rate, 0), _coded(rng, 30000, rate, 2),
               _coded(rng, 30000, rate, 3, slip=9000)]
    bj = jd.BatchedDeconvolSync(rate, 3)
    bt = td.BatchedDeconvolSync(rate, 3)
    assert bt.PERIODS == bj.PERIODS
    assert td.bytes_to_symbol_count(100, rate) == \
        jd.bytes_to_symbol_count(100, rate)
    o = [0, 0, 0]
    total = 0
    for step in (1000, 7000, 333, 9000, 5000, 12000):
        feed = []
        for c, s in enumerate(streams):
            feed.append(s[o[c]:o[c] + step + c])
            o[c] += step + c
        got, want = bt.process(feed), bj.process(feed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            total += len(g)
        np.testing.assert_array_equal(bt.locked, bj.locked)
        for g, w in zip(bt.backlogs, bj.backlogs):
            np.testing.assert_array_equal(g, w)
    assert total > 0


def test_host_blocks_dump_filter_and_fft_match_jax():
    import io
    rng = np.random.default_rng(16)
    a, b = rng.standard_normal((2, 999)).astype(np.float32)
    np.testing.assert_array_equal(tb.adder(a, b), jb.adder(a, b))
    np.testing.assert_array_equal(tb.scaler(0.3, a), jb.scaler(0.3, a))
    for w in (1, 7, 999, 1200):
        np.testing.assert_array_equal(tb.naive_lowpass(a, w),
                                      jb.naive_lowpass(a, w))
    z = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
         ).astype(np.complex64)
    for cls in ("SSEstimator", "SSAmpEstimator"):
        et, ej = getattr(tb, cls)(1024, 2048), getattr(jb, cls)(1024, 2048)
        for lo, hi in ((0, 700), (700, 3100), (3100, 5000)):
            got, want = et.process(z[lo:hi]), ej.process(z[lo:hi])
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))
    taps = tf.root_raised_cosine(32, 0.25, 0.35)
    ft, fj = io.StringIO(), io.StringIO()
    assert tf.dump_filter("rrc", taps, ft) == jf.dump_filter("rrc", taps, fj)
    assert ft.getvalue() == fj.getvalue()
    for n in (64, 1024):
        x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ).astype(np.complex64)
        want = np.asarray(jfft.fft(jnp.asarray(x)))
        got = tfft.fft(torch.from_numpy(x))
        assert got.dtype == torch.complex64
        assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
