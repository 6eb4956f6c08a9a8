"""The port's plain banked ACS (leansdr_tpu_torch/fec/viterbi_banked.py
`viterbi_acs_banked_ref`, the plain version of csrc/acs_banked.cu)
against the JAX package's banked ACS: at 3/4 the Pallas kernel itself in
interpret mode, at its minimum shape (T = P_SUB = 1024 blocks, N = 128
lanes); at 4/6, 5/6 and 7/8 the XLA scan `_viterbi_chunk_device` at
twice that length, which the JAX package's own tests hold equal to its
kernel (tests/test_viterbi_device.py:163, 287). Both from a non-zero
trellis state (the end state of a first tile).

Tolerance: none. Metrics, 64-bit paths, decoded symbols and
discriminants are integers and must be equal bit for bit, ties included
(coarse costs make metric ties frequent).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.fec import viterbi as vit
from leansdr_tpu.fec import viterbi_banked as jvb

from leansdr_tpu_torch.fec import viterbi_banked as tvb

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


def _tie_inputs(rate, T, N, seed):
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, vit.make_trellis(rate).ncs, (T, N)).astype(np.int32)
    cost = -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    return cs, cost


def _ref(rate, cs, cost, planes=None):
    N = cs.shape[1]
    z = torch.zeros((64, N), dtype=torch.int32)
    m, h, lo = planes if planes is not None else (z, z, z)
    return tvb.viterbi_acs_banked(rate, m, h, lo, torch.from_numpy(cs),
                                  torch.from_numpy(cost))


def _jax_xla(rate, start, cs, cost):
    """_viterbi_chunk_device from the port's stored-row planes: JAX holds
    [S, 64] in natural state order, u32 paths; results back to the
    port's layout."""
    geo = tvb.bank_geometry(rate)
    nat = [p.numpy()[geo.rho].T for p in start]      # [S, 64] natural
    m, hi, lo, us, q = vit._viterbi_chunk_device(
        rate, jnp.asarray(nat[0]), jnp.asarray(nat[1].view(np.uint32)),
        jnp.asarray(nat[2].view(np.uint32)), jnp.asarray(cs.T),
        jnp.asarray(cost.T))
    planes = [np.asarray(a).view(np.int32).T[geo.orig] for a in (m, hi, lo)]
    return (*planes, np.asarray(us).T, np.asarray(q).T)


@pytest.mark.parametrize("rate", ["3/4", "5/6", "4/6", "7/8"])
def test_banked_ref_matches_jax_kernel(rate):
    """3/4: against the Pallas banked kernel (its unrolled form) in
    interpret mode at T=1024, N=128; the other rates: against the XLA
    scan at T=2048, N=16. From a non-zero trellis state: metric, hi, lo,
    us and q all equal."""
    T, N = (jvb.P_SUB, 128) if rate == "3/4" else (2 * jvb.P_SUB, 16)
    cs0, cost0 = _tie_inputs(rate, T, N, seed=1)
    start = _ref(rate, cs0, cost0)[:3]
    cs, cost = _tie_inputs(rate, T, N, seed=2)
    if rate == "3/4":
        want = jvb.viterbi_acs_banked(
            rate, *(jnp.asarray(p.numpy()) for p in start),
            jnp.asarray(cs), jnp.asarray(cost), interpret=True)
    else:
        want = _jax_xla(rate, start, cs, cost)
    got = _ref(rate, cs, cost, start)
    for name, a, b in zip(("metric", "hi", "lo", "us", "q"), want, got):
        a, b = np.asarray(a), b.numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), (f"{name}: {len(bad)} differ, first "
                              f"{tuple(bad[0])}: jax {a[tuple(bad[0])]} "
                              f"port {b[tuple(bad[0])]}")


# ------------------------------------------------ the CUDA kernel's arithmetic

INT32_MAX = (1 << 31) - 1
# csrc/acs_banked.cu's headroom note: |key| < 2^KEY_BITS at each rate
# with QPSK's nshifts (the rates QPSK cannot carry: BPSK's bound), and
# < 2^KEY_BITS_BPSK with BPSK's, the most symbols per block.
KEY_BITS = {"3/4": 25, "4/6": 28, "5/6": 28, "7/8": 30, "1/2": 23,
            "2/3": 25, "4/5": 27}
KEY_BITS_BPSK = {"1/2": 23, "2/3": 25, "3/4": 26, "4/6": 29, "4/5": 27,
                 "5/6": 29, "7/8": 31}


def _kernel_model(rate, metric, hi, lo, cs, cost, nacc=4):
    """NumPy model of csrc/acs_banked.cu, in int64 so that nothing wraps:

    * each predecessor's word P_p = m_p << rb is made once per block, by
      the row that writes p;
    * a row's plain keys are P_p + rk[k, r] (7/8: the smaller of the
      predecessor's two ranks), folded into `nacc` split running minima
      and merged; the provided key P_p* + (cost << rb) + ncs comes from
      one decode
      x = tl[rcs] ^ rdec[r] (p* = x & 63, valid when x >> 8 == 0);
    * the winner's predecessor and uncoded symbol from the same decode
      at the winning rank; the path planes advance one block late;
    * blocks t = 7 (mod 8) subtract natural state 0's input word, the
      others nothing;
    * each block's best-state keys (metric << 6) | state reduced as the
      ring's reader does: least and second least over two running pairs
      (even and odd groups of 4 rows), the us at the least;
      m_out = the last block's metrics less their least.
    Returns (metric, hi, lo, us, q, the largest |key|)."""
    geo = tvb.bank_geometry(rate)
    B, K, ncs, rb = geo.B, geo.K, geo.ncs, geo.rank_bits
    nbits, depth = vit.PATH_SPEC[rate]
    shift = (depth - 1) * nbits          # 31 at 1/2: across both words
    umask, rmask, w32 = (1 << nbits) - 1, (1 << rb) - 1, 0xFFFFFFFF
    rk, aux = tvb.kernel_tables(rate)
    rk = rk.astype(np.int64)
    rdec, u0, u1, nat = (aux[i * 64:(i + 1) * 64].astype(np.int64)[:, None]
                         for i in range(4))
    tl = aux[4 * 64:].astype(np.int64)
    pb = np.array([(r >> B) << B if B <= 5 else 0 for r in range(64)])
    T, N = cs.shape
    natv = nat[:, 0]
    m = metric.astype(np.int64)
    P = np.zeros((64, N), np.int64)
    P[natv] = m << rb
    Hh = np.zeros((64, N), np.int64)
    Hl = np.zeros((64, N), np.int64)
    Hh[natv] = hi.astype(np.int64) & w32
    Hl[natv] = lo.astype(np.int64) & w32
    lane = np.arange(N)[None, :]
    us = np.zeros((T, N), np.int64)
    q = np.zeros((T, N), np.int64)
    widest = 0
    d = ub = bkey = None
    for t in range(T + 1):
        if t > 0:                       # paths and us of block t-1
            hk, lk = Hh[d, lane], Hl[d, lane]
            nh = ((hk << nbits) | (lk >> (32 - nbits))) & w32
            nl = ((lk << nbits) | ub) & w32
            Hh, Hl = np.zeros_like(Hh), np.zeros_like(Hl)
            Hh[natv], Hl[natv] = nh, nl
            pairs = []
            for half in (0, 1):          # rows 8i..8i+3, then 8i+4..8i+7
                b = np.full(N, INT32_MAX, np.int64)
                s2 = np.full(N, INT32_MAX, np.int64)
                for row in range(64):
                    if (row >> 2) & 1 == half:
                        s2 = np.minimum(s2, np.maximum(b, bkey[row]))
                        b = np.minimum(b, bkey[row])
                pairs.append((b, s2))
            (b0, s0), (b1, s1) = pairs
            best = np.minimum(b0, b1)
            second = np.minimum(np.maximum(b0, b1), np.minimum(s0, s1))
            usn = np.zeros((64, N), np.int64)
            usn[natv] = (((nh << 32) | nl) >> shift) & umask  # natural
            us[t - 1] = usn[best & 63, lane[0]]
            q[t - 1] = (second >> 6) - (best >> 6)
            if t == T:
                break
        rcs = (ncs - 1) - cs[t].astype(np.int64)
        xprov = np.where((rcs >= 0) & (rcs < ncs), tl[rcs.clip(0, ncs - 1)],
                         1 << 30)[None, :] ^ rdec
        cprov = (cost[t].astype(np.int64) << rb) + ncs
        acc = [np.full((64, N), INT32_MAX, np.int64) for _ in range(nacc)]
        for k in range(K):
            Pv = P[pb + k]
            key = Pv + rk[k][:, None]
            widest = max(widest, int(np.abs(key).max()))
            acc[k % nacc] = np.minimum(acc[k % nacc], key)
        while len(acc) > 1:
            acc = [np.minimum(a, b) for a, b in zip(acc[0::2], acc[1::2])]
        praw = P[xprov & 63, lane]
        prov = np.where((xprov >> 8) == 0, praw + cprov, INT32_MAX)
        widest = max(widest, int(np.abs(np.where(
            prov == INT32_MAX, 0, prov)).max()))
        win = np.minimum(acc[0], prov)
        base = (win & ~rmask) - (P[0] if t % 8 == 7 else 0)
        P = np.zeros_like(P)
        P[natv] = base
        wm = win >> rb
        bkey = (wm << 6) | nat
        x = np.where((win & rmask) == ncs, xprov, tl[np.minimum(
            win & rmask, ncs - 1)] ^ rdec)
        d = x & 63
        ub = np.where(((x >> 6) & 1).astype(bool) & (B == 7), u1, u0)
    mo = wm - (best >> 6)
    return (mo, Hh[natv], Hl[natv], us, q, widest)


def _extreme_inputs(rate, T, N, seed, nshifts=None):
    """Block costs at the int16-sum extremes a rate's nshifts symbols
    give: each symbol's cost -2^15, 2^15 - 1, 0 or anything between,
    summed over nshifts symbols (default bits_out / 2, QPSK's, at least
    one)."""
    rng = np.random.default_rng(seed)
    t = vit.make_trellis(rate)
    cs = rng.integers(0, t.ncs, (T, N)).astype(np.int32)
    cost = np.zeros((T, N), np.int64)
    for _ in range(nshifts or max(1, t.bits_out // 2)):
        pick = rng.integers(0, 4, (T, N))
        cost += np.where(pick == 0, -(1 << 15), np.where(
            pick == 1, (1 << 15) - 1, np.where(
                pick == 2, 0, rng.integers(-(1 << 15), 1 << 15, (T, N)))))
    return cs, cost.astype(np.int32)


def _same(want, got, what):
    for name, a, b in zip(("metric", "hi", "lo", "us", "q"), want, got):
        a = np.asarray(a).astype(np.int64)
        b = np.asarray(b).astype(np.int64)
        if name in ("hi", "lo"):
            a, b = a & 0xFFFFFFFF, b & 0xFFFFFFFF
        bad = np.argwhere(a != b)
        assert not len(bad), (f"{what} {name}: {len(bad)} differ, first "
                              f"{tuple(bad[0])}: {a[tuple(bad[0])]} vs "
                              f"{b[tuple(bad[0])]}")


@pytest.mark.parametrize("rate", tvb.BANKED_RATES)
def test_kernel_tables_match_geometry(rate):
    """kernel_tables against bank_geometry: every (row, slot) rank (7/8:
    the smaller of the predecessor's two) and the decode
    tl[rank] ^ rdec[row] giving each branch's predecessor (and
    its uncoded symbol through u0/u1), with a nonzero syndrome for every
    rank the row has no branch for."""
    geo = tvb.bank_geometry(rate)
    B, K, ncs = geo.B, geo.K, geo.ncs
    rk, aux = tvb.kernel_tables(rate)
    rdec, u0, u1, nat = (aux[i * 64:(i + 1) * 64] for i in range(4))
    tl = aux[4 * 64:]
    assert rk.shape == (K, 64) and tl.shape == (ncs,)
    np.testing.assert_array_equal(nat, geo.orig)
    for r in range(64):
        g, j = (r // K, r % K) if B <= 5 else (0, r)
        pb = g * K
        ranks = {}                      # rank -> (natural pred, us)
        for k in range(K):
            p = geo.orig[geo.pred_row[g, k]] if B <= 5 else k
            assert p == pb + k
            if geo.cs2 is None:
                ranks[ncs - 1 - geo.cs[g, k, j]] = (p, geo.us[g, j])
            else:
                ranks[ncs - 1 - geo.cs[0, k, j]] = (p, geo.us_hi[0, k, j])
                ranks[ncs - 1 - geo.cs2[0, k, j]] = (p, geo.us_lo[0, k, j])
            want = min(c for c, (pp, _) in ranks.items() if pp == p)
            assert rk[k, r] == want
        for c in range(ncs):
            x = int(tl[c] ^ rdec[r])
            if c not in ranks:
                assert x >> 8 != 0, (r, c)
                continue
            p, us = ranks[c]
            assert x >> 8 == 0 and x & 63 == p, (r, c)
            assert (u1 if B == 7 and x >> 6 & 1 else u0)[r] == us


@pytest.mark.parametrize("nacc", [2, 4])
@pytest.mark.parametrize("rate", tvb.BANKED_RATES)
def test_kernel_model_matches_ref(rate, nacc):
    """The kernel's arithmetic (model above) == viterbi_acs_banked_ref
    bit for bit: coarse costs forcing ties from zero planes, then from
    the live end state, then costs at the int16-sum extremes from that
    state; every key stays within the bound the kernel's source states
    (|key| < 2^25 at 3/4, 2^28 at 4/6 and 5/6, 2^30 at 7/8)."""
    T, N = 192, 24
    planes = tuple(torch.zeros((64, N), dtype=torch.int32)
                   for _ in range(3))
    for seed, make in ((21, _tie_inputs), (22, _tie_inputs),
                       (23, _extreme_inputs)):
        cs, cost = make(rate, T, N, seed)
        want = _ref(rate, cs, cost, planes)
        got = _kernel_model(rate, *(p.numpy() for p in planes), cs, cost,
                            nacc)
        _same(want, got[:5], f"{rate} seed {seed}")
        assert got[5] < 1 << KEY_BITS[rate]
        if make is _extreme_inputs:
            assert got[5] > 1 << (14 + tvb.bank_geometry(rate).rank_bits)
        planes = want[:3]


@pytest.mark.parametrize("rate", tvb.BANKED_RATES)
def test_kernel_model_bpsk_extremes(rate):
    """The model == viterbi_acs_banked_ref at the int16 cost extremes
    summed over BPSK's nshifts = bits_out symbols per block, the most any
    constellation puts in a block, from a live state; every key within
    the bound the kernel's source states for it (2^31 at 7/8)."""
    T, N = 128, 16
    cs0, cost0 = _tie_inputs(rate, T, N, seed=31)
    planes = _ref(rate, cs0, cost0)[:3]
    cs, cost = _extreme_inputs(rate, T, N, seed=32,
                               nshifts=vit.make_trellis(rate).bits_out)
    want = _ref(rate, cs, cost, planes)
    got = _kernel_model(rate, *(p.numpy() for p in planes), cs, cost)
    _same(want, got[:5], f"{rate} BPSK extremes")
    assert got[5] < 1 << KEY_BITS_BPSK[rate]


@pytest.mark.parametrize("rate", ["3/4", "5/6", "4/6", "7/8"])
def test_kernel_model_matches_jax(rate):
    """The model against the JAX side, from a live state at the int16
    cost extremes: 3/4 through the Pallas kernel in interpret mode
    (T=1024, N=128), the others through the XLA scan (T=512, N=16)."""
    T, N = (jvb.P_SUB, 128) if rate == "3/4" else (512, 16)
    cs0, cost0 = _tie_inputs(rate, T, N, seed=5)
    start = _ref(rate, cs0, cost0)[:3]
    cs, cost = _extreme_inputs(rate, T, N, seed=6)
    if rate == "3/4":
        want = jvb.viterbi_acs_banked(
            rate, *(jnp.asarray(p.numpy()) for p in start),
            jnp.asarray(cs), jnp.asarray(cost), interpret=True)
    else:
        want = _jax_xla(rate, start, cs, cost)
    got = _kernel_model(rate, *(p.numpy() for p in start), cs, cost)
    _same(want, got[:5], rate)
