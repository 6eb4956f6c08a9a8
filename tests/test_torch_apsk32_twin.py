"""32APSK 4/5 on one carrier: the sync election's half-turn twin, in the
JAX package and in the port alike (ROADMAP queue 3).

The 4/5 code maps data XOR 0x66 (input bits 0110 in every 4-bit block)
onto its code XOR 0b00110 in every 5-bit block, and 0b00110 is the
label change of 32APSK's 180-degree rotation (the sync maps of rotation
r and r + 2 differ by XOR 6). So a decoder replica whose sync map is a
half-turn from the one the stream was sent under decodes a valid code
sequence at the same metrics: the two discriminants tie in every chunk,
the election (argmax, strictly greater switches) keeps the lower index,
and when the carrier loop settles on rotation 2 or 3 the receiver
decodes data XOR 0x66 and never finds the MPEG sync.

  * the decoders (`ViterbiSyncDevice`) of both packages on a 4/5 stream
    sent under each of the 8 syncs: the same elected sync (the lower of
    each half-turn pair), tied discriminants, the same bytes, data or
    data XOR 0x66; and the sync it was sent under, pinned, decodes data;
  * the first two reads of `chip_smoke.py`'s `apsk32_45` stimulus (its seed,
    1 s at 4 Msps, 2 Msym/s, +20 kHz, Es/N0 24 dB, --sampler rrc)
    through the JAX DvbsReceiver on the CPU: no lock, the sent symbols
    come out under the half-turn twin of the elected sync; the port's
    decoder on the last 16461 of those softsymbols elects the same
    sync, ties, and puts out the same bytes as a JAX decoder;
  * every (constellation, rate) the receivers take: the sync pairs the
    code cannot tell apart in the same way (half-turns at 64APSKe 5/6
    and the QAMs too, conjugate pairs at 8PSK and others).

Run as a script, the JAX DvbsReceiver takes the whole stimulus and
prints its lock, elected sync and packets per read:

    JAX_PLATFORMS=cpu python tests/test_torch_apsk32_twin.py [--reads N]

Tolerance: none. Syncs, discriminants and bytes are integers.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.fec import convenc, interleave, prbs, rs
from leansdr_tpu_torch.fec import viterbi as tvit
from leansdr_tpu_torch.pipelines import tsgen

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HALF_TURN = 6              # 32APSK's 180-degree label change (XOR)
PATTERN = 0x66             # the data change the code maps onto it
READ = 1 << 17             # leandvb's samples per read
TAIL = 128 * 128 + 77      # softsymbols of the stimulus both decoders take


def _twin(s, nrot=4):
    """The sync a half-turn from sync s."""
    r = s % nrot
    return s - r + (r + nrot // 2) % nrot


def _contains(out: np.ndarray, data: np.ndarray, xor: int) -> bool:
    """Whether the bytes `out` hold 64 bytes of `data` XOR `xor` from its
    middle, at any bit offset."""
    want = np.unpackbits(data[len(data) // 2:len(data) // 2 + 64]
                         ^ np.uint8(xor))
    got = np.unpackbits(out)
    return any((got[o:o + len(want)] == want).all()
               for o in range(len(got) - len(want) + 1))


def _decoders():
    from leansdr_tpu.dsp import cstln as jc
    from leansdr_tpu.fec import viterbi as jv
    cst = make_dvbs2_constellation(Predef.APSK32, "4/5")
    jcst = jc.make_dvbs2_constellation(jc.Predef.APSK32, "4/5")
    return (tvit.ViterbiSyncDevice(cst, "4/5", fastlock=True, device="cpu"),
            jv.ViterbiSyncDevice(jcst, "4/5", fastlock=True))


def _electing(t):
    """Records (elected, discriminants) of each of t's chunks."""
    seen, advance = [], t._advance

    def wrapper(us, totaldiscr, election):
        out = advance(us, totaldiscr, election)
        seen.append((t.current, totaldiscr.copy()))
        return out
    t._advance = wrapper
    return seen


def test_half_turn_is_xor6():
    """The sync maps of rotations r and r + 2 differ by XOR 6, and the
    4/5 code's steady output for input block 0110 is 0b00110."""
    cst = make_dvbs2_constellation(Predef.APSK32, "4/5")
    maps, nconj, nrot, nshifts = tvit.make_sync_maps(cst, "4/5")
    assert (len(maps), nconj, nrot, nshifts) == (8, 2, 4, 1)
    for s in range(8):
        np.testing.assert_array_equal(maps[_twin(s)], maps[s] ^ HALF_TURN)
    data = np.full(64, PATTERN, np.uint8)
    cs, _ = convenc.encode(data, "4/5", 5)
    assert (np.asarray(cs)[8:] == HALF_TURN).all()


def _steady_outputs(rate) -> set:
    """The code blocks (trellis labels) the code puts out, in steady
    state, for an input that repeats one block."""
    t = tvit.make_trellis(rate)
    out = set()
    for us in range(t.nus):
        s = 0
        for _ in range(16):
            ns, cs = np.argwhere((t.pred == s) & (t.us == us))[0]
            s = ns
        out.add(int(cs))
    return out - {0}


# (constellation, rate): the sync pairs whose maps differ by one XOR
# that the code puts out in steady state, as (kind, XOR): "half" a
# half-turn (the same conj, rotations nrot/2 apart), "conj" a pair
# across the conjugate maps.
TWINS = {
    ("QPSK", "5/6"): {("conj", 1), ("conj", 2)},
    ("PSK8", "2/3"): {("conj", 1)}, ("PSK8", "4/6"): {("conj", 1)},
    ("PSK8", "5/6"): {("conj", 2)}, ("APSK16", "3/4"): {("conj", 2)},
    ("APSK32", "4/5"): {("half", 6)},
    ("APSK64E", "2/3"): {("conj", 1)}, ("APSK64E", "4/6"): {("conj", 1)},
    ("APSK64E", "5/6"): {("half", 3)},
    ("QAM16", "3/4"): {("half", 15)}, ("QAM16", "7/8"): {("half", 15)},
    ("QAM64", "2/3"): {("half", 63), ("conj", 7), ("conj", 56)},
    ("QAM64", "4/6"): {("half", 63), ("conj", 7), ("conj", 56)},
    ("QAM64", "5/6"): {("half", 63), ("conj", 7), ("conj", 56)},
    ("QAM256", "7/8"): {("half", 255)},
}


def test_transparent_twins_by_constellation():
    """Every (constellation, rate) the receivers take: the sync-map
    pairs that differ by an XOR the code maps a repeated data block
    onto (at the trellis rate the single carrier decodes)."""
    from leansdr_tpu_torch.fec.viterbi_banked import viterbi_rate
    found = {}
    for p in Predef:
        for rate in ("1/2", "2/3", "3/4", "4/6", "5/6", "7/8", "4/5"):
            try:
                cst = make_dvbs2_constellation(p, rate)
                vrate = viterbi_rate(rate, cst.nsymbols)
                maps, nconj, nrot, nshifts = tvit.make_sync_maps(cst, vrate)
            except ValueError:
                continue
            outs, bps = _steady_outputs(vrate), cst.bits_per_symbol
            kinds = set()
            for a in range(len(maps)):
                for b in range(a + 1, len(maps)):
                    x = set((maps[a] ^ maps[b]).tolist())
                    blk = 0
                    for _ in range(nshifts):
                        blk = (blk << bps) | min(x)
                    if len(x) == 1 and blk in outs:
                        half = (a // nrot == b // nrot
                                and (b - a) % nrot == nrot // 2)
                        kinds.add(("half" if half else "conj", min(x)))
            if kinds:
                found[(p.name, rate)] = kinds
    assert found == TWINS


@pytest.mark.parametrize("sync", range(8))
def test_twin_election_matches_jax(sync):
    """A 4/5 stream sent under `sync`: both packages elect the lower of
    its half-turn pair, with tied discriminants in every chunk, and put
    out the same bytes (data, or data XOR 0x66 from the twin); the port's
    decoder with `sync` pinned (no election) decodes the data."""
    rng = np.random.default_rng(40 + sync)
    data = rng.integers(0, 256, 4 * 200, dtype=np.uint8)
    cs, _ = convenc.encode(data, "4/5", 5)
    t, j = _decoders()
    syms = np.argsort(t.maps[t.sync_map[sync]])[np.asarray(cs)].astype(
        np.uint8)
    costs = (-rng.integers(20, 120, len(syms))).astype(np.int16)
    seen = _electing(t)
    got, want = [], []
    for lo, hi in ((0, 300), (300, 900), (900, len(syms))):
        got.append(t.process(syms[lo:hi], costs[lo:hi]))
        want.append(j.process(syms[lo:hi], costs[lo:hi]))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_array_equal(want, got)
    elected = min(sync, _twin(sync))
    assert t.current == j.current == elected
    assert len(seen) >= 8
    assert all(v[sync] == v[_twin(sync)] for _, v in seen)
    assert _contains(got, data, 0 if elected == sync else PATTERN)
    assert not _contains(got, data, PATTERN if elected == sync else 0)
    pinned, _ = _decoders()
    pinned.current = sync
    pinned.resync_phase, pinned.resync_period = 1, 1 << 62
    out = pinned.process(syms, costs)
    assert pinned.current == sync and _contains(out, data, 0)


def _chip_stimulus() -> bytes:
    """chip_smoke.py's apsk32_45 stimulus: its seed's noise after the two
    slice-8 paths before it (each draws 2 x samples normals)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    rng = np.random.default_rng(cs.SEED_8)
    for p in cs.SC_PATHS_8:
        name, fields, fmt, seconds, updown, f_off, esn0, birdie, _ = p
        if name == "apsk32_45":
            return cs.sc_stimulus(fields["constellation"], fields["rate"],
                                  fields["Fs"], seconds, updown, f_off,
                                  esn0, birdie, fmt, rng)[0]
        n = int(round(seconds * fields["Fs"]))
        rng.standard_normal(n)
        rng.standard_normal(n)
    raise AssertionError("no apsk32_45 path")


def _jax_receiver():
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    return DvbsReceiver(RxConfig(
        Fs=4e6, Fm=2e6, constellation=JP.APSK32, rate="4/5", fastlock=True,
        viterbi=True, anf=0, sampler="rrc", float_scale=75.0,
        exact_lut=False))


def _sent_symbols(npkt=400) -> np.ndarray:
    """The 32APSK 4/5 symbol labels of chip_smoke's first `npkt` sent
    packets (the modulator's chain before its mapper)."""
    randomized, _ = prbs.randomize(tsgen.generate(npkt), 0)
    ilv, _ = interleave.interleave(rs.encode(randomized))
    syms, _ = convenc.encode(ilv[:len(ilv) // 4 * 4], "4/5", 5)
    return np.asarray(syms, np.int64)


def _match(got: np.ndarray, sent: np.ndarray, base: int):
    """The best fraction of `got` (received labels from symbol `base`)
    equal to the sent labels, over offsets of +-3000 symbols."""
    best = 0.0
    for off in range(-3000, 3000):
        s = base + off
        if 0 <= s and s + len(got) <= len(sent):
            best = max(best, float(np.mean(got == sent[s:s + len(got)])))
    return best


def test_chip_apsk32_stimulus_elects_twin_in_jax():
    """The first two reads of chip_smoke's apsk32_45 stimulus through the JAX
    DvbsReceiver: no lock; the received symbols are the sent ones under
    the half-turn twin of the elected sync, not under the elected one.
    On the last TAIL of those softsymbols, a fresh decoder of each
    package elects the same sync, the twin tied in every chunk, and both
    put out the same bytes."""
    from leansdr_tpu.util.iofmt import read_iq
    raw = _chip_stimulus()
    j = _jax_receiver()
    pieces, process = [], j.deconv.process

    def capture(syms, costs):
        pieces.append((np.array(syms), np.array(costs)))
        return process(syms, costs)
    j.deconv.process = capture
    for k in range(2):
        j.process(read_iq(raw[k * READ * 8:(k + 1) * READ * 8], "f32"))
    assert not j.lock
    e = j.deconv.current
    t = _twin(e)
    syms = np.concatenate([p[0] for p in pieces]).astype(np.int64)
    assert len(syms) > 120000
    window = syms[-4100:-100]
    base = len(syms) - 4100
    sent = _sent_symbols()
    maps = j.deconv.maps[j.deconv.sync_map]          # per sync
    assert _match(maps[t][window], sent, base) > 0.99
    assert _match(maps[e][window], sent, base) < 0.5

    # Fresh decoders on the last TAIL softsymbols, in two pieces.
    costs = np.concatenate([p[1] for p in pieces])
    port, jax = _decoders()
    seen = _electing(port)
    got, want = [], []
    n = len(syms)
    for lo, hi in ((n - TAIL, n - TAIL // 2), (n - TAIL // 2, n)):
        got.append(port.process(syms[lo:hi].astype(np.uint8), costs[lo:hi]))
        want.append(jax.process(syms[lo:hi].astype(np.uint8), costs[lo:hi]))
    assert port.current == jax.current == e
    assert len(seen) == TAIL // 128
    assert all(v[e] == v[t] for _, v in seen)
    np.testing.assert_array_equal(np.concatenate(want), np.concatenate(got))


def main(argv) -> int:
    """The JAX DvbsReceiver on the whole stimulus, in leandvb's reads."""
    import argparse
    from leansdr_tpu.util.iofmt import read_iq
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1 << 30)
    a = ap.parse_args(argv)
    raw = _chip_stimulus()
    j = _jax_receiver()
    out, t0 = [], time.perf_counter()
    for k, o in enumerate(range(0, len(raw), READ * 8)):
        if k >= a.reads:
            break
        out.append(j.process(read_iq(raw[o:o + READ * 8], "f32")))
        mer = j.meas["mer"][-1] if j.meas["mer"] else None
        print(f"read {k}: lock {j.lock}, elected sync {j.deconv.current}, "
              f"{len(out[-1])} packets, MER {mer}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(lock=bool(j.lock), elected=int(j.deconv.current),
                          reads=len(out),
                          packets=int(sum(len(p) for p in out)))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
