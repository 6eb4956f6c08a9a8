"""The segmented demod's handover (pipelines/multi_rx._cut) where the two
trajectories at a boundary emit one row apart.

The stand-in demod here emits a DVB-S stream's QPSK symbols, symbol k at
stream row 2k + offset, the offset held in the lane's state (plane 0):
the sequential demod and segment 0 at offset 1, and, from one chunk on,
the precursor of segment 1 ends at offset 2, so that segment 1 lags
segment 0 by one row at that chunk's boundary. Its overlap window then
opens on segment 1's copy of a symbol whose segment-0 copy lies before
the window; where that symbol's label equals the next one's, the first
pair of emissions at most one row apart is two neighbouring symbols,
which the rule that took the first such pair cut after, duplicating a
symbol. The stream's start is chosen so that this happens at the
boundary, once the decoder is locked.

Also: the benchmark's reference copy of the rule (sdrbench/reference_seg.py)
against the port, on that boundary, on simulated windows with jitter,
offsets and symbol errors, and on the benchmark's fixture of the engine.
"""

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp.cstln import Predef
from leansdr_tpu_torch.pipelines import multi_rx
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
from leansdr_tpu_torch.util import trace
from sdrbench import reference as R
from sdrbench import reference_seg, stimulus

torch.set_num_threads(1)

T = multi_rx._SEG_T
S, NSEG, W = 2, 2048, 256
CHUNK = S * NSEG
LAG_CHUNK = 24          # the chunk whose boundary 1 opens on a lag
NPKT = 64


def _symbols() -> np.ndarray:
    """The QPSK symbols of NPKT numbered TS packets through the benchmark's
    TX chain (randomizer, RS, interleaver, rate-1/2 code), around the
    loop."""
    pkts = stimulus.ts_packets(1, NPKT)
    rand = pkts ^ stimulus.prbs_pattern().reshape(8, stimulus.TS_SIZE)[
        np.arange(NPKT) % 8]
    rs = stimulus.rs_encode(torch.from_numpy(
        rand.reshape(-1, stimulus.TS_SIZE)))
    stream = stimulus.interleave_circular(
        rs.reshape(1, NPKT, stimulus.RS_SIZE))
    return stimulus.encode_circular(stream)[0].numpy().astype(np.uint8), pkts


def _first_pair_cut(va, sa, vb, sb):
    """The former rule: the cut after the first pair of equal labels at
    rows at most one apart (case0/1/2 with their silence guards)."""
    c0 = va[:-1] & vb[:-1] & (sa[:-1] == sb[:-1])
    c1 = va[:-1] & vb[1:] & (sa[:-1] == sb[1:]) & ~va[1:]
    c2 = va[1:] & vb[:-1] & (sa[1:] == sb[:-1]) & ~vb[1:]
    anyc = c0 | c1 | c2
    first = torch.argmax(anyc.to(torch.int32), dim=0)
    cut = torch.where(torch.gather(c0, 0, first[None])[0], first + 1,
                      first + 2)
    return torch.where(anyc.any(dim=0), cut, torch.full_like(cut, T))


@pytest.fixture(scope="module")
def lagged_run():
    """The fleet (one carrier, hard decisions, S=2 from chunk 1) on the
    stand-in demod over 70 chunks; the engine's boundary windows and
    outputs, the TS given back and the sent symbols."""
    X, pkts = _symbols()
    H = len(X)
    ra = 1
    w0 = LAG_CHUNK * CHUNK + NSEG - T       # boundary 1's window, stream row
    # The first symbol of the window is segment 1's unpaired copy of
    # symbol w0/2 - 1; start the stream where its label equals the next.
    k_off = next(k for k in range(H)
                 if X[(w0 // 2 - 1 + k) % H] == X[(w0 // 2 + k) % H])
    seen = []

    def demod(params, sym_consts, planes, x):
        n = x.shape[1] - ra
        g0 = x[:, 0, 0].round().to(torch.int64)            # stream rows
        off = planes[0].round().to(torch.int64)
        g = g0[None, :] + torch.arange(n)[:, None]
        valid = ((g - off[None, :]) % 2 == 0) & (g >= off[None, :])
        k = torch.div(g - off[None, :], 2, rounding_mode="floor")
        sym = torch.from_numpy(X)[(k + k_off) % H]
        st = planes.clone()
        if n == W:                                          # pass 1
            st[0] = torch.where(g0 + n > LAG_CHUNK * CHUNK, 2.0, 1.0)
        packed = (valid.to(torch.int32) << 24) | (sym.to(torch.int32) << 16)
        return st, packed.contiguous()

    cut = multi_rx._cut

    def cut_seen(va, sa, vb, sb):
        out = cut(va, sa, vb, sb)
        seen.append((va, sa, vb, sb) + out)
        return out

    segmented = multi_rx._demod_segmented
    spliced = []

    def segmented_seen(*a, **kw):
        out = segmented(*a, **kw)
        spliced.append((out[2][:, 0].clone(), out[3][:, 0].clone()))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(multi_rx.rk, "demod", demod)
    mp.setattr(multi_rx, "_cut", cut_seen)
    mp.setattr(multi_rx, "_demod_segmented", segmented_seen)
    trace.reset()
    try:
        cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2",
                       constellation=Predef.QPSK, sampler="linear",
                       fastlock=True, viterbi=False, exact_lut=False,
                       float_scale=1.0)
        rx = multi_rx.MultiDvbsReceiver(cfg, 1, chunk_samples=CHUNK,
                                        segments=S, seg_warmup=W,
                                        seg_holdoff=1, device="cpu")
        assert rx.readahead == ra
        rx.dem_state = rx.dem_state.clone()
        rx.dem_state[0] = 1.0
        n = 70 * CHUNK + ra
        x = np.zeros((1, n, 2), np.float32)
        x[0, :, 0] = np.arange(n)
        ts = [rx.process(x[:, :CHUNK + ra])[0]]
        ts += [rx.process(x[:, k * CHUNK + ra:(k + 1) * CHUNK + ra])[0]
               for k in range(1, 70)]
        counts = trace.counters()
    finally:
        mp.undo()
        trace.reset()
    return dict(X=X, k_off=k_off, pkts=pkts[0], seen=seen,
                spliced=spliced, ts=np.concatenate(ts), counts=counts)


def test_lagged_boundary_keeps_every_symbol(lagged_run):
    """At the lagged boundary the first pair at most one row apart is two
    neighbouring symbols: the former rule's cut there gives one symbol
    twice; the rule's cut gives the stream's symbols in order, as the
    sequential demod emits them, and is counted as realigned."""
    r = lagged_run
    X, H = r["X"], len(r["X"])
    va, sa, vb, sb, cut, found, moved = r["seen"][LAG_CHUNK - 1]
    assert bool(found[0]) and bool(moved[0])
    assert int(moved.sum()) == r["counts"]["seg.realigned"] == 1
    old = int(_first_pair_cut(va, sa, vb, sb)[0])
    new = int(cut[0])

    def splice(c):
        return torch.cat([sa[:c, 0][va[:c, 0]], sb[c:, 0][vb[c:, 0]]])

    first = (LAG_CHUNK * CHUNK + NSEG - T) // 2     # a's first symbol
    want = torch.from_numpy(X[(np.arange(first, first + 64) + r["k_off"])
                              % H])
    assert torch.equal(splice(new), want[:len(splice(new))])
    dup = splice(old)
    assert len(dup) == len(splice(new)) + 1 and dup[0] == dup[1]
    # The whole chunk as spliced: the stream's symbols, one after another.
    sym, valid = r["spliced"][LAG_CHUNK - 1]
    got = sym[valid].numpy()
    k0 = (LAG_CHUNK * CHUNK - 1) // 2 + 1
    np.testing.assert_array_equal(
        got, X[(np.arange(k0, k0 + len(got)) + r["k_off"]) % H])


def test_lagged_boundary_decodes_every_packet(lagged_run):
    """From the first packet that equals one sent (until the derandomizer
    meets its first inverted sync a packet may carry another phase of its
    sequence), the TS given back are the packets sent, in order, none
    lost, through the lagged chunk (bytes ~6 kB into the stream)."""
    ts = lagged_run["ts"]
    sent = lagged_run["pkts"]
    num = (ts[:, 1].astype(np.int64) << 16 | ts[:, 2].astype(np.int64) << 8
           | ts[:, 3])
    good = (ts == sent[num % NPKT]).all(axis=1)
    first = int(np.argmax(good))
    assert good.any() and first <= 8
    ts, num = ts[first:], num[first:]
    assert len(ts) >= 50
    assert (np.diff(num) % NPKT == 1).all()
    np.testing.assert_array_equal(ts, sent[num % NPKT])


def _windows(rng, n):
    """Simulated overlap windows [T, n]: two trajectories of one symbol
    stream, emission rows 2k + offset with jitter, the incoming one 0 or
    1 row late or early, some symbol errors. Returns each trajectory's
    validity, labels and symbol numbers k (-1 where it emits nothing)."""
    va, sa, vb, sb = (np.zeros((T, n), bool), np.zeros((T, n), np.uint8),
                      np.zeros((T, n), bool), np.zeros((T, n), np.uint8))
    ka, kb = np.full((T, n), -1), np.full((T, n), -1)
    for i in range(n):
        X = rng.integers(0, 4, 120)
        lag = rng.integers(-1, 2)
        for v, s, ks, base, p in (
                (va, sa, ka, 10, rng.choice([0, .05, .3])),
                (vb, sb, kb, 10 + lag, rng.choice([0, .05, .3]))):
            last = -1
            err = rng.choice([0, 0, .02])
            for k in range(len(X)):
                row = max(2 * k + base + (rng.random() < p), last + 1)
                last = row
                w = row - 14 - i % 4
                if 0 <= w < T:
                    v[w, i] = True
                    ks[w, i] = k
                    s[w, i] = X[k] if rng.random() >= err else \
                        rng.integers(0, 4)
    return va, sa, ka, vb, sb, kb


UNRELATED = 40      # windows whose incoming labels are redrawn at random


@pytest.fixture(scope="module")
def windows():
    """400 simulated windows, the first UNRELATED with no alignment."""
    rng = np.random.default_rng(11)
    va, sa, ka, vb, sb, kb = _windows(rng, 400)
    sb[:, :UNRELATED] = rng.integers(0, 4, (T, UNRELATED))
    return va, sa, ka, vb, sb, kb


def test_reference_copy_equals_the_port_on_windows(lagged_run, windows):
    """reference_seg.cut equals the port's _cut bit for bit on the lagged
    boundary and on simulated windows (jitter, one-row lags either way,
    symbol errors, and unrelated labels)."""
    va, sa, vb, sb, cut, found, _ = lagged_run["seen"][LAG_CHUNK - 1]
    rc, rf = reference_seg.cut(va.numpy(), sa.numpy(), vb.numpy(),
                               sb.numpy())
    assert np.array_equal(rc, cut.numpy())
    assert np.array_equal(rf, found.numpy())
    va, sa, _, vb, sb, _ = windows
    t = [torch.from_numpy(a) for a in (va, sa, vb, sb)]
    cut, found, moved = multi_rx._cut(*t)
    rc, rf = reference_seg.cut(va, sa, vb, sb)
    assert np.array_equal(rc, cut.numpy())
    assert np.array_equal(rf, found.numpy())
    assert bool(moved.any())


def test_cut_keeps_the_symbol_sequence_on_windows(windows):
    """On every simulated window of one stream the mended cut splices the
    symbols in order, none given twice and none lost; the former rule
    does not on some; wherever the former rule's splice was right, and
    on the windows with no alignment, the cut is the former one."""
    va, sa, ka, vb, sb, kb = windows
    t = [torch.from_numpy(a) for a in (va, sa, vb, sb)]
    cut, found, moved = (a.numpy() for a in multi_rx._cut(*t))
    former = _first_pair_cut(*t).numpy()

    def in_order(c, i):
        k = np.concatenate([ka[:c, i][va[:c, i]], kb[c:, i][vb[c:, i]]])
        return len(k) > 0 and bool((np.diff(k) == 1).all())

    u = UNRELATED
    assert found[u:].all()
    assert all(in_order(cut[i], i) for i in range(u, len(cut)))
    right = np.array([in_order(former[i], i) for i in range(len(cut))])
    assert not right[u:].all()
    assert np.array_equal(cut[u:][right[u:]], former[u:][right[u:]])
    assert np.array_equal(cut[:u], former[:u])
    assert np.array_equal(moved[u:], ~right[u:])


def test_reference_copy_equals_the_port_on_the_engine(monkeypatch):
    """reference_seg.Demod.segmented equals the port's engine bit for bit
    on the benchmark's fixture (tests of sdrbench/reference.py), as the
    former reference does: there the first pair is always aligned."""
    from leansdr_tpu_torch.dsp import mf_prefilter
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig as Cfg
    tr = dict(carriers=3, packets_per_loop=16, esn0_db=12.0,
              offset_center=1, offset_step=5e-6)
    cap = stimulus.make_capture(tr, 7, "cpu", float_scale=75.0)
    rx = multi_rx.MultiDvbsReceiver(
        Cfg(Fs=4e6, Fm=2e6, rate="1/2", constellation=Predef.QPSK,
            sampler="rrc", fastlock=True, viterbi=True, exact_lut=False,
            float_scale=1.0), 3, device="cpu")
    n = 1024
    dem = rx.dem_state.clone()
    seg = multi_rx.init_seg_state(dem, 3, S, n // S)
    x = cap.iq[:, 5000:5000 + n + rx.readahead]
    out = multi_rx._demod_segmented(rx.params, rx._sym_consts, rx.mf_taps,
                                    3, S, W, True, dem, seg, x)
    ref = reference_seg.Demod(4e6, 2e6, 0.35, 30.0, 1 / 6, "cpu")
    monkeypatch.setattr(R, "matched_filter", lambda taps, fw, xx, p="fp32":
                        mf_prefilter.mf_prefilter(
                            rx.mf_taps, torch.from_numpy(np.asarray(fw)), xx))
    for a, b in zip(out, ref.segmented(S, W, dem.numpy(), seg.numpy(), x)):
        assert np.array_equal(a.numpy(), b)


def test_rotations_equal_the_boundary_by_boundary_estimate(windows):
    """_rotations (every boundary's counts at once, the choice walked by
    composing rotations) equals the estimate made boundary by boundary in
    the base frame of the segment before, ties and the T//8 floor
    included; on the windows of one stream it finds each segment's true
    lock offset."""
    va, sa, _, vb, sb, _ = (torch.from_numpy(a) for a in windows)
    S, C = 9, 40                           # 8 boundaries of 40 carriers
    cols = slice(UNRELATED, UNRELATED + (S - 1) * C)
    va, sa, vb, sb = va[:, cols], sa[:, cols], vb[:, cols], sb[:, cols]
    rng = np.random.default_rng(5)
    true = torch.from_numpy(rng.integers(0, 4, (S, C)))
    true[0] = 0
    # Thin some windows to a few emissions (ties, the floor) and leave
    # a few silent.
    thin = torch.from_numpy(rng.random((T, (S - 1) * C)) < 0.1)
    sparse = torch.from_numpy(rng.random((S - 1) * C) < 0.3)
    va = va & (thin | ~sparse)
    vb = vb & (thin | ~sparse)
    vb[:, :3] = False

    def rot(x, r):
        return multi_rx._rot_label(x, r)

    sa_raw = torch.cat([rot(sa[:, j * C:(j + 1) * C], true[j])
                        for j in range(S - 1)], dim=1)
    sb_raw = torch.cat([rot(sb[:, j * C:(j + 1) * C], true[j + 1])
                        for j in range(S - 1)], dim=1)
    got = multi_rx._rotations(va, sa_raw, vb, sb_raw, C)
    want = [torch.zeros(C, dtype=torch.int64)]
    for j in range(S - 1):
        c = slice(j * C, (j + 1) * C)
        a, b = rot(sa_raw[:, c], want[-1]), sb_raw[:, c]
        ya, yb = va[:, c], vb[:, c]
        br = [f.to(torch.uint8) for f in multi_rx._rot_forms(b)]
        cnt = torch.stack([
            ((ya[:-1] & yb[:-1] & (a[:-1] == br[r][:-1]))
             | (ya[:-1] & yb[1:] & (a[:-1] == br[r][1:]))
             | (ya[1:] & yb[:-1] & (a[1:] == br[r][:-1]))).sum(0)
            for r in range(4)])
        want.append(torch.where(cnt.amax(0) >= T // 8, cnt.argmax(0), 0))
    want = torch.cat(want)
    assert torch.equal(got, want)
    # Where every boundary up to a segment agreed, its offset maps the
    # segment's labels back to the stream's: rot(true) then rot(offset).
    full = ~sparse.reshape(S - 1, C)
    full[0, :3] = False
    chained = torch.cumprod(full.to(torch.int64), 0).bool()
    back = (true[1:] + got.reshape(S, C)[1:]) % 4
    assert chained.sum() > 100
    assert bool((back[chained] == 0).all())
