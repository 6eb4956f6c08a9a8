"""The port's time-segmented demod (pipelines/multi_rx._demod_segmented,
MultiDvbsReceiver(segments=S), DvbsReceiver with RxConfig.segments and
leandvb --segments) against the JAX package's segmented engine with its
Pallas demod in interpret mode, on stimulus delayed by a fraction of a
sample per carrier (see tests/test_torch_fleet.py for why).

The JAX side runs in a child process with multiply-add contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX, as in tests/test_torch_dvbs_rx.py),
while the port runs in the test's own process. With contraction on, the
fleet's loop state drifts from the port's over a few chunks (the phase
by about one unit of 65536 in four segmented chunks) and a soft cost now
and then lands one s8 grid step apart, which moves an election
discriminant (ROADMAP queue 3); with it off they are equal.

Tolerance: symbols, valid flags, soft costs, the fleet's packed fetch
buffers (decoded bytes, discriminants, underflow flags, ring fill),
decoded bytes and TS exactly equal; loop state (the carried chunk-head
planes and every persisted segment state) within the f32 bar
max(1e-3, 1e-4*|v|) of tests/test_receiver_pallas.py, the lock phase
modulo one turn (65536).
"""

import io
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu.pipelines import dvbs_tx, tsgen

from leansdr_tpu_torch.convert import from_jax_checkpoint
from leansdr_tpu_torch.dsp import mf_prefilter, receiver
from leansdr_tpu_torch.dsp import receiver_kernel as rk
from leansdr_tpu_torch.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_tpu_torch.pipelines import multi_rx as TM
from leansdr_tpu_torch.pipelines.dvbs_rx import DvbsReceiver, RxConfig
from test_torch_dvbs_rx import FMA_OFF, REPO
from test_torch_dvbs_rx import N as SC_N
from test_torch_dvbs_rx import _drive, _nonempty
from test_torch_dvbs_rx import _stimulus as sc_stimulus

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

C = 2
CHUNK = 4096
DELAYS = (0.3, 0.6)
CFG = dict(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True, float_scale=75,
           exact_lut=False, viterbi=True, sampler="rrc")
SEG = dict(segments=2, seg_warmup=256, seg_holdoff=2)
LOOP = dict(omega=2.0, sampler="linear", nsymbols=4, exact_lut=False,
            pll_adjustment=1.0 / 6)


def _frames(rate, npkt):
    iqs = []
    for c, d in enumerate(DELAYS):
        q = dvbs_tx.modulate(tsgen.generate(npkt, start=500 * c),
                             dvbs_tx.TxConfig(rate=rate, interp=2))
        iqs.append((1 - d) * q[:-1] + d * q[1:])
    n = min(map(len, iqs))
    return np.stack([q[:n] for q in iqs]).astype(np.float32)


def _lanes(tiles, lanes):
    """The JAX kernel's [19, nsub, 128] lane tiles -> [19, lanes]."""
    return np.asarray(tiles).reshape(rk.NSTATE, -1)[:, :lanes]


def _assert_state_close(want, got, what):
    """[19, L] planes within the f32 bar, phase (row 1) modulo a turn."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    for row in range(rk.NSTATE):
        d = got[row] - want[row]
        if row == 1:
            d = (d + 32768) % 65536 - 32768
        tol = np.maximum(1e-3, 1e-4 * np.abs(want[row]))
        assert (np.abs(d) <= tol).all(), (what, row, want[row], got[row])


def _start_jax(tmp_path, name, **args):
    """The JAX side `name(**args)` in a child process with multiply-add
    contraction off; returns a function that waits for its result."""
    src, dst = tmp_path / f"{name}.in", tmp_path / f"{name}.out"
    src.write_bytes(pickle.dumps(args))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.Popen([sys.executable, __file__, name, str(src),
                             str(dst)], env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def result():
        log = proc.communicate(timeout=900)[0].decode(errors="replace")
        assert proc.returncode == 0, log[-3000:]
        return pickle.loads(dst.read_bytes())
    return result


# ------------------------------------------------------- the JAX sides

def _jax_fleet(rate, use_pallas=True, **seg):
    from leansdr_tpu.pipelines.dvbs_rx import RxConfig as JaxRxConfig
    from leansdr_tpu.pipelines.multi_rx import MultiDvbsReceiver
    j = MultiDvbsReceiver(JaxRxConfig(**dict(CFG, rate=rate)), C,
                          use_pallas=use_pallas, chunk_samples=CHUNK, **seg)
    if rate != "1/2":
        # The banked Pallas ACS in interpret mode (the CPU's default is
        # the XLA scan), as tests/test_torch_fleet_punctured.py does.
        j.deconv = type(j.deconv)(j.cstln, j.rate, C, CHUNK, j.omega,
                                  banked=True, interpret=True)
    return j


def jax_engine(fr, planes, taps, S, W, n, warm, ra):
    """Two chunks of JAX's _demod_segmented from `planes` (the second with
    +16384 on carrier 0's segment-0 phase); per chunk its outputs."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import receiver as jreceiver
    from leansdr_tpu.dsp import receiver_pallas as jrp
    from leansdr_tpu.dsp.cstln import Predef as JPredef
    from leansdr_tpu.dsp.cstln import make_dvbs2_constellation
    from leansdr_tpu.pipelines import multi_rx as JM
    params = jreceiver.ReceiverParams(**LOOP)
    sc = jrp.sym_constants(make_dvbs2_constellation(JPredef.QPSK, "1/2"))
    dem = jnp.asarray(np.pad(planes, ((0, 0), (0, jrp.LANE - C)))
                      .reshape(rk.NSTATE, 1, jrp.LANE))
    seg = JM.init_seg_state(True, dem, C, S, n // S)
    out = [_lanes(seg, S * C)]
    for k in range(2):
        if k == 1:
            seg = seg.at[1, 0, 0].add(16384.0)
        x = jnp.asarray(fr[:, warm + k * n:warm + (k + 1) * n + ra])
        dem, seg, sym, val, cost = JM._demod_segmented(
            params, sc, taps, C, S, W, True, True, True, None, dem, seg, x)
        out.append(dict(dem=_lanes(dem, C), seg=_lanes(seg, S * C),
                        sym=np.asarray(sym), val=np.asarray(val),
                        cost=np.asarray(cost)))
    return out


def jax_fleet_run(rate, blocks, seg):
    """The JAX fleet over `blocks`; per chunk (packed buffer, decode
    shapes, TS per channel), and its final segment length."""
    j = _jax_fleet(rate, **seg)
    out = []
    for blk in blocks:
        pend = j.dispatch(blk)
        if pend is None:
            out.append(None)
            continue
        buf = np.asarray(pend[0])
        out.append((buf, pend[1], j.collect(pend)))
    return out, j._seg_nseg


def jax_checkpoints(fr, n, seg):
    """JAX fleet checkpoints holding segment states: after one segmented
    chunk of the Pallas path (with the receiver's next packed buffer),
    and of the XLA-scan path with its cold-start segment states (JAX's
    init_seg_state for that layout; its demod is not run). Each with its
    segment states as [19, S*C] planes."""
    from leansdr_tpu.dsp import receiver_pallas as jrp
    from leansdr_tpu.pipelines.multi_rx import init_seg_state
    j = _jax_fleet("1/2", **seg)
    j.collect(j.dispatch(fr[:, :n]))
    out = dict(blob=j.save_state(), seg=_lanes(j._seg_state, 2 * C),
               nseg=j._seg_nseg,
               next=np.asarray(j.dispatch(fr[:, n:2 * n])[0]))
    s = _jax_fleet("1/2", use_pallas=False, **seg)
    S = seg["segments"]
    s._seg_state = init_seg_state(False, s.state, C, S, n // S)
    s._seg_nseg = n // S
    out.update(scan_blob=s.save_state(), scan_nseg=s._seg_nseg,
               scan_seg=_lanes(jrp.pack_state(s._seg_state), S * C))
    return out


# ------------------------------------------------------------ the tests

def test_demod_segmented_matches_jax(tmp_path):
    """_demod_segmented called directly (C=2, S=2, seg_warmup=256, 2048
    samples a chunk) from a locked state, on both sides: a chunk from the
    cold-start segment states (init_seg_state), then the next chunk from
    the persisted ones with +16384 (90 degrees) injected into carrier 0's
    segment-0 phase, so pass 1 seeds carrier 0's segment 1 a quadrant
    away: the rotation estimate relabels it (rhat = 1) and the handover
    cuts run on relabelled symbols. The port's injected chunk gives the
    same symbols as its uninjected twin, and its persisted phase comes
    back derotated."""
    S, W, n, warm = 2, 256, 2048, 2048
    fr = _frames("1/2", 14) * np.float32(75)
    pt = receiver.ReceiverParams(**LOOP)
    sct = rk.sym_constants(make_dvbs2_constellation(Predef.QPSK, "1/2"))
    taps = tuple(mf_prefilter.make_mf_taps(4e6, 2e6, 0.35, 30.0))
    ra = pt.readahead + len(taps) - 1
    # Lock: `warm` samples through the port's sequential demod.
    planes = rk.pack_state(receiver.init_state(pt, C, "cpu"))
    x0 = torch.from_numpy(fr[:, :warm + ra])
    dem, _ = rk.demod(pt, sct, planes,
                      mf_prefilter.mf_prefilter(taps, planes[2], x0))
    jax_out = _start_jax(tmp_path, "jax_engine", fr=fr, planes=dem.numpy(),
                         taps=taps, S=S, W=W, n=n, warm=warm, ra=ra)
    seg = TM.init_seg_state(dem, C, S, n // S)
    got = [seg.numpy()]
    for k in range(2):
        x = torch.from_numpy(fr[:, warm + k * n:warm + (k + 1) * n + ra])
        if k == 1:
            twin = TM._demod_segmented(pt, sct, taps, C, S, W, True, dem,
                                       seg.clone(), x)
            seg = seg.clone()
            seg[1, 0] += 16384.0
        dem, seg, sym, val, cost = TM._demod_segmented(
            pt, sct, taps, C, S, W, True, dem, seg, x)
        assert sym.shape == (n, C) and int(val.sum()) > n // 2
        got.append(dict(dem=dem.numpy(), seg=seg.numpy(), sym=sym.numpy(),
                        val=val.numpy(), cost=cost.numpy()))
    want = jax_out()
    np.testing.assert_array_equal(want[0], got[0])       # init_seg_state
    for k in (1, 2):
        for key in ("val", "sym", "cost"):
            np.testing.assert_array_equal(want[k][key], got[k][key],
                                          err_msg=f"chunk {k} {key}")
        _assert_state_close(want[k]["dem"], got[k]["dem"], f"{k} head")
        _assert_state_close(want[k]["seg"], got[k]["seg"], f"{k} segments")
    # The relabel undid the injected quadrant: same symbols as the twin,
    # and segment 1's persisted phase derotated back near the twin's.
    np.testing.assert_array_equal(sym.numpy(), twin[2].numpy())
    np.testing.assert_array_equal(val.numpy(), twin[3].numpy())
    d = float(seg[1, C] - twin[1][1, C])
    assert abs((d + 32768) % 65536 - 32768) < 2048, d


def _port_fleet(rate, **seg):
    return TM.MultiDvbsReceiver(RxConfig(**dict(CFG, rate=rate)), C,
                                chunk_samples=CHUNK, device="cpu", **seg)


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_fleet_segmented_matches_jax(rate, tmp_path):
    """MultiDvbsReceiver(segments=2, seg_warmup=256, seg_holdoff=2) from
    cold for 6 chunks of 4096 samples: two sequential, four segmented;
    packed fetch buffers (the Viterbi decoder's bytes) and TS byte-equal
    chunk by chunk."""
    fr = _frames(rate, 28)
    blocks = [fr[:, k * CHUNK:(k + 1) * CHUNK] for k in range(6)]
    jax_out = _start_jax(tmp_path, "jax_fleet_run", rate=rate,
                         blocks=blocks, seg=SEG)
    t = _port_fleet(rate, **SEG)
    got = []
    for blk in blocks:
        pend = t.dispatch(blk)
        got.append(None if pend is None else
                   (pend[0].numpy(), pend[1], t.collect(pend)))
    want, nseg = jax_out()
    decodes = 0
    for k, (a, b) in enumerate(zip(want, got)):
        assert (a is None) == (b is None), f"chunk {k}: dispatch differs"
        if a is None:
            continue
        bad = np.argwhere(a[0] != b[0]) if a[0].shape == b[0].shape else [0]
        assert not len(bad), f"chunk {k}: packed buffers differ at {bad[:4]}"
        assert a[1] == b[1], f"chunk {k}: decode shapes differ"
        for c in range(C):
            np.testing.assert_array_equal(a[2][c], b[2][c])
        decodes += len(b[1]) if k >= SEG["seg_holdoff"] else 0
    assert decodes >= 2, decodes     # segmented symbols reached the decoder
    assert t._chunk_count == 6 and t._seg_nseg == nseg > 0
    assert tuple(t._seg_state.shape) == (rk.NSTATE, 2 * C)


def test_segmented_checkpoints(tmp_path):
    """Checkpoints taken mid-segmentation: a JAX fleet checkpoint holding
    seg_state in the Pallas layout ([19, nsub, 128] tiles) converts into
    the port, the port's own save_state/load_state round-trips it, and
    JAX, the converted and the reloaded receiver then give byte-equal
    packed buffers. A JAX checkpoint of the XLA-scan demod path (a dict of
    [S*C] arrays) converts to the same segment planes as JAX's."""
    fr = _frames("1/2", 14)
    n = CHUNK // 2                   # 2048-sample blocks
    seg = dict(SEG, seg_holdoff=0)   # segmented from the first chunk
    j = _start_jax(tmp_path, "jax_checkpoints", fr=fr, n=n, seg=seg)()
    a = _port_fleet("1/2", **seg)
    a.load_state(from_jax_checkpoint(j["blob"]))
    b = _port_fleet("1/2", **seg)
    b.load_state(a.save_state())
    np.testing.assert_array_equal(a._seg_state.numpy(), j["seg"])
    assert a._seg_nseg == b._seg_nseg == j["nseg"] > 0
    blk = fr[:, n:2 * n]
    pa, pb = a.dispatch(blk), b.dispatch(blk)
    np.testing.assert_array_equal(j["next"], pa[0].numpy())
    np.testing.assert_array_equal(pa[0].numpy(), pb[0].numpy())
    with pytest.raises(ValueError, match="segments"):
        _port_fleet("1/2", segments=4).load_state(a.save_state())
    c = _port_fleet("1/2", **seg)
    c.load_state(from_jax_checkpoint(j["scan_blob"]))
    np.testing.assert_array_equal(c._seg_state.numpy(), j["scan_seg"])
    assert c._seg_nseg == j["scan_nseg"] == n // 2


def test_segment_guardrails():
    """segments >= 1 and seg_warmup % 128 == 0 are checked (the single
    carrier too, which the JAX package does not check); segments*nchan
    above the TPU kernel's 1024-lane tile is accepted."""
    cfg = RxConfig(**CFG)
    with pytest.raises(ValueError, match="segments"):
        TM.MultiDvbsReceiver(cfg, C, segments=0, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        TM.MultiDvbsReceiver(cfg, C, segments=2, seg_warmup=100,
                             device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        DvbsReceiver(RxConfig(exact_lut=False, segments=2, seg_warmup=100),
                     device="cpu")
    rx = TM.MultiDvbsReceiver(cfg, 600, segments=2, device="cpu")
    seg = TM.init_seg_state(rx._planes, 600, 2, 4096)
    assert rx.segments == 2 and tuple(seg.shape) == (rk.NSTATE, 1200)


@pytest.mark.parametrize("case", ["omega2-viterbi-rrc", "omega1.2-hard"])
def test_dvbs_segmented_matches_jax(case, monkeypatch, tmp_path):
    """DvbsReceiver with --segments against the JAX receiver, two calls of
    8192 samples, the first sequential (seg_holdoff=1), the second
    segmented: at omega 2 (--viterbi --sampler rrc --fastlock, rate 1/2)
    segments=4, seg_warmup=256; at omega 1.2 (hard decisions, linear
    sampler, the notch, rate 7/8: leandvb's defaults) segments=2,
    seg_warmup=128.
    Every call's demod outputs on lane 0 of both passes, the decoder's
    inputs (symbols, and costs with --viterbi), decoded bytes, TS,
    backlogs, measurements and state are compared."""
    if case == "omega2-viterbi-rrc":
        x = sc_stimulus("1/2", 6, 3, 1, 20, 2e-4)
        kw = dict(Fs=4e6, Fm=2e6, rate="1/2", viterbi=True, sampler="rrc",
                  fastlock=True, anf=0, segments=4, seg_warmup=256)
        nseg = 2048
    else:
        x = sc_stimulus("7/8", 6, 10, 3, 40)
        kw = dict(Fs=2.4e6, Fm=2e6, rate="7/8", anf=1, segments=2,
                  seg_warmup=128)
        nseg = 4096
    kw.update(float_scale=75.0, exact_lut=False, Finfo=500.0, seg_holdoff=1)
    t, _, rt = _drive(x, kw, SC_N, 2, monkeypatch, tmp_path)
    _nonempty(rt)
    assert t._chunks_done == 2 and t._seg_nseg == nseg
    S = kw["segments"]
    assert tuple(t._seg_state.shape) == (rk.NSTATE, S)
    # Two demod launches per segmented call: pass 1 + pass 2 (+128 rows).
    assert len(rt[-1]["packed"]) == kw["seg_warmup"] + nseg + 128
    u = DvbsReceiver(RxConfig(**kw), device="cpu")
    u.load_state(t.save_state())
    assert u._chunks_done == 2 and torch.equal(u._seg_state, t._seg_state)


def test_leandvb_segments_reaches_receiver(monkeypatch):
    """leandvb --segments 4 --device cpu parses and builds its receiver
    with segments=4 (an empty stdin ends the run)."""
    from leansdr_tpu_torch.apps import leandvb
    from leansdr_tpu_torch.pipelines import dvbs_rx
    made = []

    class Rx(dvbs_rx.DvbsReceiver):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device)
            made.append(self)

    monkeypatch.setattr(dvbs_rx, "DvbsReceiver", Rx)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"")))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(io.BytesIO()))
    assert leandvb.main(["--f32", "--segments", "4", "--device", "cpu"]) == 0
    assert len(made) == 1 and made[0].cfg.segments == 4
    assert made[0].device.type == "cpu"


if __name__ == "__main__":
    # The JAX sides: python test_torch_segmented.py NAME ARGS.pkl OUT.pkl
    name, src, dst = sys.argv[1:]
    args = pickle.loads(Path(src).read_bytes())
    Path(dst).write_bytes(pickle.dumps(globals()[name](**args)))
