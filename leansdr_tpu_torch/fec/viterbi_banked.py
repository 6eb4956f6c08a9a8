"""Banked ACS for every trellis rate with more than one symbol per block
or bits_in > 1: the counterpart of leansdr_tpu/fec/viterbi_banked.py.

viterbi_sync's punctured-rate decoding (reference dvb.h:1179-1212:
puncturing expanded into the trellis, 2^bits_in branches per state,
nshifts symbol-offset replicas) as a constant-geometry ACS; rate 1/2
runs here too (B=1) where a constellation spreads its block over more
than one symbol (BPSK) or has other than 4 sync maps:

* bits_in = B <= 5: the predecessors of new state s' are the CONTIGUOUS
  block [(s' mod G)*K, +K) with K = 2^B, G = 64/K, and the uncoded
  symbol is a function of s' alone. Metric planes are stored under the
  mixed-radix digit swap rho(s) = (s mod G)*K + (s div G), so each
  bank's K outputs are a contiguous row block.
* bits_in = 7 (rate 7/8): every state connects to every state (64 preds
  x 2 coded symbols per edge), one bank.

Tie-breaking matches viterbi_dec exactly (viterbi.h:202-244): candidate
keys pack (metric << RB) | rank with rank = NCS-1-cs for plain branches
and NCS for the provided-with-metric branch, so one min reduction
realizes "provided first, then branches cs-ascending, last minimum
wins". Keys are unique per (row, lane) (asserted in bank_geometry), so
a running min over the predecessors in any order is exact. The
best-state scan packs (metric << 6) | state ('<' ascending, FIRST
minimum wins). Paths are 64-bit register-exchange words (bitpath,
viterbi.h:287-293) split over two i32 planes.

`viterbi_acs_banked` launches csrc/acs_banked.cu for CUDA tensors and
runs `viterbi_acs_banked_ref`, the plain PyTorch version, for CPU
tensors. Lanes are unpadded: the planes are [64, N].
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev
from ..util import trace
from .viterbi import NSTATES, PATH_SPEC, make_trellis

BIG = 1 << 30
# Every trellis rate the decoders hand the banked ACS: 1/2 (B=1, BPSK
# and the other constellations with other than 4 sync replicas), 2/3
# (B=2; the single carrier keeps it for BPSK and 8PSK), 4/6, 3/4, 4/5
# (B=4, its own polynomials), 5/6 and 7/8.
BANKED_RATES = ("1/2", "2/3", "4/6", "3/4", "4/5", "5/6", "7/8")
# The QPSK fleet's punctured rates ("2/3" runs as "4/6").
QPSK_PUNCTURED = ("4/6", "3/4", "5/6", "7/8")


def fleet_rate(rate: str) -> str:
    """The trellis rate the fleet runs for DVB-S code rate `rate`, at any
    constellation: 2/3 as the 4/6 trellis (leansdr_tpu/pipelines/
    multi_rx.py:740), the others as they are. The hard-decision
    deconvolver of the single carrier takes the same rule."""
    return "4/6" if rate == "2/3" else rate


def viterbi_rate(rate: str, nsymbols: int) -> str:
    """The trellis rate the single carrier's Viterbi runs for DVB-S code
    rate `rate`: 2/3 as 4/6 for QPSK and 64APSKe only (leandvb.cc:
    533-537; leansdr_tpu/pipelines/dvbs_rx.py:344), so BPSK and 8PSK
    keep the 2/3 trellis."""
    return "4/6" if rate == "2/3" and nsymbols in (4, 64) else rate


@dataclass(frozen=True)
class BankGeometry:
    rate: str
    B: int                    # bits_in
    K: int                    # 2^B branches per state (64 preds for B=7)
    G: int                    # number of banks (64/K), 1 for B=7
    ncs: int                  # 2^bits_out
    rank_bits: int            # bits needed for rank in the packed key
    rho: np.ndarray           # [64] state -> stored row
    orig: np.ndarray          # [64] stored row -> state
    pred_row: np.ndarray      # [G, K] stored row of pred k of bank g
    # Static per-output-row columns (j indexes the bank's output rows,
    # i.e. stored rows g*K+j):
    cs: np.ndarray            # [G, K, K]  cs[g,k,j]: plain branch cs
    us: np.ndarray            # [G, K]     us[g,j] uncoded symbol of s'
    # 7/8 only (G == 1): second coded symbol + per-branch us
    cs2: np.ndarray | None    # [1, K2, 64] smaller cs per pred (B=7)
    us_hi: np.ndarray | None  # [1, K2, 64] us of larger-cs branch
    us_lo: np.ndarray | None  # [1, K2, 64] us of smaller-cs branch


@lru_cache(maxsize=None)
def bank_geometry(rate: str) -> BankGeometry:
    t = make_trellis(rate)
    B, ncs = t.bits_in, t.ncs
    rank_bits = int(np.ceil(np.log2(ncs + 1)))
    if B <= 5:
        K, G = 1 << B, NSTATES >> B
        rho = np.array([(s % G) * K + (s // G) for s in range(NSTATES)],
                       np.int32)
        orig = np.argsort(rho).astype(np.int32)
        pred_row = np.zeros((G, K), np.int32)
        cs = np.zeros((G, K, K), np.int32)
        us = np.zeros((G, K), np.int32)
        for g in range(G):
            for k in range(K):
                pred_row[g, k] = rho[g * K + k]
            for j in range(K):
                sp = j * G + g
                assert len(set(t.in_us[sp])) == 1
                # Coded symbols are distinct across the K branches into
                # a state: packed candidate keys are then UNIQUE per
                # (row, lane), so an order-free strict-< running min
                # reproduces the reference scan exactly.
                assert len(set(t.in_cs[sp])) == K, (rate, sp)
                us[g, j] = t.in_us[sp][0]
                for k in range(K):
                    p = g * K + k
                    hit = np.where(t.in_pred[sp] == p)[0]
                    assert len(hit) == 1
                    cs[g, k, j] = t.in_cs[sp][hit[0]]
        return BankGeometry(rate, B, K, G, ncs, rank_bits, rho, orig,
                            pred_row, cs, us, None, None, None)
    assert B == 7, rate
    # 7/8: one bank; k iterates the 64 predecessors; each (pred, state)
    # pair carries two branches (two coded symbols).
    K2 = NSTATES
    rho = np.arange(NSTATES, dtype=np.int32)
    pred_row = np.arange(NSTATES, dtype=np.int32).reshape(1, K2)
    cs_hi = np.zeros((1, K2, NSTATES), np.int32)
    cs_lo = np.zeros((1, K2, NSTATES), np.int32)
    us_hi = np.zeros((1, K2, NSTATES), np.int32)
    us_lo = np.zeros((1, K2, NSTATES), np.int32)
    us = np.zeros((1, NSTATES), np.int32)   # unused for B=7
    for sp in range(NSTATES):
        per = {}
        for i in range(t.nus):
            per.setdefault(int(t.in_pred[sp][i]), []).append(
                (int(t.in_cs[sp][i]), int(t.in_us[sp][i])))
        for p, v in per.items():
            assert len(v) == 2
            (c0, u0), (c1, u1) = sorted(v)
            cs_lo[0, p, sp], us_lo[0, p, sp] = c0, u0
            cs_hi[0, p, sp], us_hi[0, p, sp] = c1, u1
    # All 128 coded symbols into a state are distinct (unique keys).
    for sp in range(NSTATES):
        assert len(set(cs_hi[0, :, sp]) | set(cs_lo[0, :, sp])) == 128
    return BankGeometry(rate, B, K2, 1, ncs, rank_bits, rho, rho,
                        pred_row, cs_hi, us, cs_lo, us_hi, us_lo)


for _rate in BANKED_RATES:           # the uniqueness asserts, at import
    bank_geometry(_rate)
del _rate


@lru_cache(maxsize=None)
def _row_tables(rate: str):
    """Per stored output row r and predecessor slot k ([64, K] int32):
    the pred's stored row, the ranks ncs-1-cs of its (larger, smaller)
    coded symbol and the us of those branches. For B <= 5 the smaller-cs
    columns are unused and both us columns hold us of the row's state."""
    geo = bank_geometry(rate)
    K = geo.K
    prow = np.zeros((NSTATES, K), np.int32)
    rk = np.zeros((NSTATES, K), np.int32)
    rk2 = np.full((NSTATES, K), 0xFF, np.int32)
    uh = np.zeros((NSTATES, K), np.int32)
    ul = np.zeros((NSTATES, K), np.int32)
    for r in range(NSTATES):
        g, j = (r // K, r % K) if geo.B <= 5 else (0, r)
        prow[r] = geo.pred_row[g]
        rk[r] = geo.ncs - 1 - geo.cs[g, :, j]
        if geo.cs2 is None:
            uh[r] = geo.us[g, j]
        else:
            rk2[r] = geo.ncs - 1 - geo.cs2[0, :, j]
            uh[r] = geo.us_hi[0, :, j]
            ul[r] = geo.us_lo[0, :, j]
    return prow, rk, rk2, uh, ul


def _gf2_decoder(img: list, n: int):
    """Tables of the linear map inverse to v -> sum of img[i] over the
    set bits i of v (GF(2), n-bit images, injective): for every n-bit c,
    (L[c], H[c]) with c = image(L[c]) ^ (the complement vector H[c]
    names), so H[c] == 0 exactly on the image."""
    basis = list(img)
    span = {0}
    for v in basis:
        span |= {x ^ v for x in span}
    for i in range(n):
        if (1 << i) not in span:
            basis.append(1 << i)
            span |= {x ^ (1 << i) for x in span}
    assert len(span) == 1 << n and len(basis) == n
    L = np.zeros(1 << n, np.int64)
    H = np.zeros(1 << n, np.int64)
    for a in range(1 << n):
        c = 0
        for i, v in enumerate(basis):
            if a >> i & 1:
                c ^= v
        L[c], H[c] = a & ((1 << len(img)) - 1), a >> len(img)
    return L, H


@lru_cache(maxsize=None)
def kernel_tables(rate: str):
    """The tables csrc/acs_banked.cu reads, as (rk [K, 64], aux) int32.

    The trellis is linear over GF(2): a block's coded symbol is
    cs = Mf(v) ^ Ms(s'), where s' is the new state and v the B free bits
    of the shift register (the predecessor's low B bits for B <= 5; the
    whole predecessor and the first input bit b for 7/8). Hence:

    * rk[k, r]: the rank ncs-1-cs of the branch from natural
      predecessor pb(r) + k into stored row r (pb = (r >> B) << B for
      B <= 5, 0 for 7/8). At 7/8 a predecessor feeds a row through two
      branches, and since both keys share its metric the smaller rank
      alone can win: rk is that smaller rank.
    * decode: for a rank c, x = tl[c] ^ rdec[r] is the natural
      predecessor of the branch of row r with coded symbol ncs-1-c in
      bits 0-5 (7/8: and b in bit 6), and bits 8+ hold its syndrome,
      zero exactly when row r has such a branch (asserted for every
      rank of every row).
    * u0[r], u1[r]: the uncoded symbol of row r's branches with b = 0
      and 1 (the row's one us for B <= 5); nat[r]: its natural state.

    aux is [rdec, u0, u1, nat] (four [64] rows, by stored row), then
    tl [ncs]."""
    geo = bank_geometry(rate)
    t = make_trellis(rate)
    B, ncs, K = geo.B, geo.ncs, geo.K
    free = (1 << B) - 1
    v_of = ((lambda p, u: p | ((u >> 6) & 1) << 6) if B == 7
            else (lambda p, u: p))
    img = {v_of(int(p), int(u)) & free: int(c) for p, u, c in zip(
        t.in_pred[0], t.in_us[0], t.in_cs[0])}          # state 0: Ms = 0
    L, H = _gf2_decoder([img[1 << i] for i in range(B)], t.bits_out)
    tl = np.array([L[ncs - 1 - c] | H[ncs - 1 - c] << 8
                   for c in range(ncs)], np.int64)
    rk = np.zeros((K, NSTATES), np.int64)
    rdec = np.zeros(NSTATES, np.int64)
    u = np.zeros((2, NSTATES), np.int64)
    nat = geo.orig.astype(np.int64)
    for r in range(NSTATES):
        sp = int(nat[r])
        pb = (r >> B) << B if B <= 5 else 0
        rank = {}
        v0 = v_of(int(t.in_pred[sp][0]), int(t.in_us[sp][0]))
        rdec[r] = (L[t.in_cs[sp][0]] ^ v0) | H[t.in_cs[sp][0]] << 8
        for p, us, c in zip(t.in_pred[sp], t.in_us[sp], t.in_cs[sp]):
            p, us, c = int(p), int(us), int(c)
            assert pb <= p < pb + K
            rank[p] = min(rank.get(p, ncs), ncs - 1 - c)
            x = int(tl[ncs - 1 - c] ^ rdec[r])
            assert x == v_of(p, us), (rate, r, c)
            u[(x >> 6) & 1 if B == 7 else 0, r] = us
        if B <= 5:
            u[1, r] = u[0, r]
        rk[:, r] = [rank[pb + k] for k in range(K)]
        for c in range(ncs):               # no branch: nonzero syndrome
            x = int(tl[c] ^ rdec[r])
            assert (x >> 8 == 0) == (c in {ncs - 1 - int(v)
                                           for v in t.in_cs[sp]})
    aux = np.concatenate([rdec, u[0], u[1], nat, tl])
    return (np.ascontiguousarray(rk, np.int32),
            np.ascontiguousarray(aux, np.int32))


def viterbi_acs_banked_ref(rate: str, metric: torch.Tensor,
                           path_hi: torch.Tensor, path_lo: torch.Tensor,
                           cs: torch.Tensor, cost: torch.Tensor):
    """Plain PyTorch banked ACS over T blocks: the arithmetic of
    leansdr_tpu/fec/viterbi_banked.acs_block_np in int32, vectorised
    over stored rows, predecessor slots and lanes.

    metric/path_hi/path_lo [64, N] i32 in stored-row order; cs/cost
    [T, N] i32 (cs the full bits_out-bit block symbol, cost the summed
    softsymbol costs, <= 0). Returns (metric, path_hi, path_lo,
    us [T, N] i32 decoded symbol at traceback depth, q [T, N] i32
    best2-best discriminant).
    """
    geo = bank_geometry(rate)
    nbits, depth = PATH_SPEC[rate]
    shift = (depth - 1) * nbits          # the traceback depth's bit
    RB, ncs, K = geo.rank_bits, geo.ncs, geo.K
    dev = cs.device
    T, N = cs.shape
    prow, rk, rk2, uh, ul = (torch.from_numpy(a).to(dev)
                             for a in _row_tables(rate))
    rk3, rk23 = rk[:, :, None], rk2[:, :, None]           # [64, K, 1]
    flat = prow.reshape(-1).to(torch.int64)
    ocol = torch.from_numpy(geo.orig).to(dev)[:, None]    # [64, 1]
    carry = (1 << nbits) - 1
    m, hi, lo = metric.clone(), path_hi.clone(), path_lo.clone()
    us = torch.empty((T, N), dtype=torch.int32, device=dev)
    q = torch.empty((T, N), dtype=torch.int32, device=dev)
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    for t in range(T):
        rcs = (ncs - 1) - cs[t]                                # [N]
        cshift = cost[t] << RB
        base = m[flat].reshape(64, K, N) << RB                 # [64, K, N]
        prov = (base + cshift) | ncs
        key = base | rk3
        if geo.cs2 is None:
            key = torch.where(rk3 == rcs, torch.minimum(key, prov), key)
        else:
            hit = (rk3 == rcs) | (rk23 == rcs)
            key = torch.minimum(torch.minimum(key, base | rk23),
                                torch.where(hit, prov, big))
        win, k = key.min(dim=1)                                # [64, N]
        src = prow.gather(1, k).to(torch.int64)
        hk, lk = hi.gather(0, src), lo.gather(0, src)
        if geo.cs2 is None:
            usv = uh[:, :1]
        else:
            rank = win & ((1 << RB) - 1)
            rk_w, rk2_w = rk.gather(1, k), rk2.gather(1, k)
            uh_w, ul_w = uh.gather(1, k), ul.gather(1, k)
            usv = torch.where(rank == ncs,
                              torch.where(rk_w == rcs, uh_w, ul_w),
                              torch.where(rank == rk2_w, ul_w, uh_w))
        wm = win >> RB
        hi = (hk << nbits) | ((lk >> (32 - nbits)) & carry)
        lo = (lk << nbits) | usv
        bkey = (wm << 6) | ocol
        bk, best = bkey.min(dim=0)                             # [N]
        bm = bk >> 6
        bh = hi.gather(0, best[None])[0]
        if shift >= 32:
            us[t] = (bh >> (shift - 32)) & carry
        else:                            # 1/2: across the two words
            bl = lo.gather(0, best[None])[0]
            us[t] = (((bl >> shift) & ((1 << (32 - shift)) - 1))
                     | (bh << (32 - shift))) & carry
        second = torch.where(bkey == bk, big, bkey).amin(dim=0) >> 6
        q[t] = second - bm
        m = wm - bm
    return m, hi, lo, us, q


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _dev.load("acs_banked")
        lib.acs_banked_launch.restype = ctypes.c_int
        lib.acs_banked_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        _lib = lib
    return _lib


_tables = {}


def _device_tables(rate: str, dev):
    """kernel_tables(rate) (rk [K, 64], aux) int32 on `dev`, cached."""
    key = (rate, str(dev))
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(a).to(dev).contiguous()
                             for a in kernel_tables(rate))
    return _tables[key]


def viterbi_acs_banked(rate: str, metric: torch.Tensor,
                       path_hi: torch.Tensor, path_lo: torch.Tensor,
                       cs: torch.Tensor, cost: torch.Tensor):
    """Banked ACS over T blocks (same contract as viterbi_acs_banked_ref).

    CPU tensors run `viterbi_acs_banked_ref`; CUDA tensors launch
    csrc/acs_banked.cu with the tables of `kernel_tables` (T must be a
    multiple of 64).
    """
    if cs.device.type == "cpu":
        return viterbi_acs_banked_ref(rate, metric, path_hi, path_lo, cs,
                                      cost)
    T, N = cs.shape
    if T == 0 or T % 64:
        raise ValueError(f"T={T} is not a positive multiple of 64")
    dev = cs.device
    for name, t, shape in (("metric", metric, (64, N)),
                           ("path_hi", path_hi, (64, N)),
                           ("path_lo", path_lo, (64, N)),
                           ("cs", cs, (T, N)), ("cost", cost, (T, N))):
        _dev.check_tensor(name, t, torch.int32, shape, dev)
    geo = bank_geometry(rate)
    nbits, depth = PATH_SPEC[rate]
    lib = _kernel()
    rk, aux = _device_tables(rate, dev)
    m2, h2, l2 = (torch.empty_like(metric) for _ in range(3))
    us = torch.empty((T, N), dtype=torch.int32, device=dev)
    q = torch.empty((T, N), dtype=torch.int32, device=dev)
    with trace.span("kernel.acs_banked"):
        err = lib.acs_banked_launch(
            rk.data_ptr(), aux.data_ptr(), metric.data_ptr(),
            path_hi.data_ptr(), path_lo.data_ptr(), cs.data_ptr(),
            cost.data_ptr(), m2.data_ptr(), h2.data_ptr(), l2.data_ptr(),
            us.data_ptr(), q.data_ptr(), T, N, geo.B, nbits,
            (depth - 1) * nbits - 32, geo.rank_bits, geo.ncs,
            _dev.stream_handle(cs))
    _dev.check_launch("acs_banked", err)
    trace.count("launch.acs_banked")
    return m2, h2, l2, us, q
