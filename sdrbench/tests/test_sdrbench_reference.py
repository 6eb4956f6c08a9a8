"""The stimulus and the plain reference: the capture, decoded by the
reference alone, gives back the packets sent; the reference's demod and
segmented engine equal the program's plain versions bit for bit given
the same matched-filter output; the TX copy equals the program's."""

import numpy as np
import pytest
import torch

from sdrbench import reference as R
from sdrbench import stimulus as st

torch.set_num_threads(1)


def _enc(m):
    return st.rs_encode(torch.from_numpy(np.ascontiguousarray(m))).numpy()


def test_capture_decoded_by_the_reference_gives_back_the_packets():
    tr = dict(carriers=1, packets_per_loop=48, esn0_db=30.0,
              offset_center=0, offset_step=3e-6)
    cap = st.make_capture(tr, 2 ** 33 + 9, "cpu", float_scale=75.0)
    ref = R.Demod(4e6, 2e6, 0.35, 30.0, 1 / 6, "cpu")
    n = 100 * 1024
    x = torch.cat([cap.iq, cap.iq], 1)[:, :n + ref.readahead]
    _, sym, valid, _ = ref.run(R.init_state(1), x)
    pk = R.ts_from_symbols(sym[valid[:, 0], 0], st.prbs_pattern(), _enc)
    assert len(pk) >= 4
    nums = ((pk[:, 1].astype(int) << 16) | (pk[:, 2].astype(int) << 8)
            | pk[:, 3])
    assert (np.diff(nums) == 1).all()
    assert all((p == cap.packets[0, k]).all() for p, k in zip(pk, nums))


def test_tx_copy_equals_the_programs_tx():
    from leansdr_tpu_torch.dsp import filtergen
    from leansdr_tpu_torch.fec import convenc, interleave, prbs, rs
    N = 32
    pk = st.ts_packets(2, N)
    r, _ = prbs.randomize(pk[1], 0)
    rsp = rs.encode(r)
    ilv, _ = interleave.interleave(rsp)
    sym_p, _ = convenc.encode(ilv, "1/2", 2)
    rand = pk ^ st.prbs_pattern().reshape(8, 188)[np.arange(N) % 8]
    rsm = st.rs_encode(torch.from_numpy(rand.reshape(-1, 188)))
    assert (rsm.numpy().reshape(2, N, 204)[1] == rsp).all()
    stream = st.interleave_circular(rsm.reshape(2, N, 204))
    assert (stream.numpy()[1][:len(ilv)] == ilv).all()
    sym = st.encode_circular(stream).numpy()[1]
    assert (sym[16:len(sym_p)] == sym_p[16:]).all()
    taps = filtergen.normalize_power(
        filtergen.root_raised_cosine(20, 0.5, 0.35), 1 / 75)
    assert np.array_equal(taps, st.rrc_taps())


def _fleet(C, S=2):
    from leansdr_tpu_torch.pipelines import multi_rx
    from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=1.0, exact_lut=False, viterbi=True,
                   sampler="rrc")
    return multi_rx.MultiDvbsReceiver(cfg, C, chunk_samples=4096,
                                      segments=S, seg_warmup=256,
                                      seg_holdoff=0, device="cpu")


def test_reference_demod_equals_the_programs_plain_demod():
    from leansdr_tpu_torch.dsp import mf_prefilter
    from leansdr_tpu_torch.dsp import receiver_kernel as rk
    from leansdr_tpu_torch.pipelines import multi_rx
    tr = dict(carriers=3, packets_per_loop=16, esn0_db=12.0,
              offset_center=1, offset_step=5e-6)
    cap = st.make_capture(tr, 77, "cpu", float_scale=75.0)
    rx = _fleet(3)
    ref = R.Demod(4e6, 2e6, 0.35, 30.0, 1 / 6, "cpu")
    assert np.array_equal(np.asarray(rx.mf_taps, np.float32), ref.taps)
    st0 = rx.dem_state.clone()
    x = cap.iq[:, 300:300 + 512 + rx.readahead]
    z = mf_prefilter.mf_prefilter(rx.mf_taps, st0[2], x)
    zr = R.matched_filter(ref.taps, st0[2].numpy(), x)
    assert float((z - zr).abs().max()) <= 1e-6 * float(z.abs().max())
    pst, packed = rk.demod_ref(rx.params, rx._sym_consts, st0, z)
    rst, sym, valid, cost = R.demod(ref.K, ref.trig, st0.numpy(), z.numpy())
    psym, pval, pcost = multi_rx._extract_sym_valid(packed)
    assert np.array_equal(pst.numpy(), rst)
    assert np.array_equal(psym.numpy(), sym)
    assert np.array_equal(pval.numpy(), valid)
    assert np.array_equal(pcost.numpy(), cost)


def test_reference_segmented_engine_equals_the_programs(monkeypatch):
    from leansdr_tpu_torch.dsp import mf_prefilter
    from leansdr_tpu_torch.pipelines import multi_rx
    tr = dict(carriers=3, packets_per_loop=16, esn0_db=12.0,
              offset_center=1, offset_step=5e-6)
    cap = st.make_capture(tr, 7, "cpu", float_scale=75.0)
    rx = _fleet(3)
    S, W, n = 2, 256, 1024
    dem = rx.dem_state.clone()
    seg = multi_rx.init_seg_state(dem, 3, S, n // S)
    x = cap.iq[:, 5000:5000 + n + rx.readahead]
    out = multi_rx._demod_segmented(rx.params, rx._sym_consts, rx.mf_taps,
                                    3, S, W, True, dem, seg, x)
    ref = R.Demod(4e6, 2e6, 0.35, 30.0, 1 / 6, "cpu")
    # The same matched-filter output on both sides: the engines agree
    # bit for bit.
    monkeypatch.setattr(R, "matched_filter", lambda taps, fw, xx, p="fp32":
                        mf_prefilter.mf_prefilter(
                            rx.mf_taps, torch.from_numpy(np.asarray(fw)), xx))
    r = ref.segmented(S, W, dem.numpy(), seg.numpy(), x)
    for a, b in zip(out, r):
        assert np.array_equal(a.numpy(), b)


def test_reference_notch_equals_the_programs():
    from leansdr_tpu_torch.dsp.blocks_device import BatchedAutoNotch
    rng = np.random.default_rng(5)
    n = 4096 * 6
    t = np.arange(n)
    x = rng.standard_normal((n, 2)).astype(np.float32) * 10
    x[:, 0] += 40 * np.cos(2 * np.pi * 0.0625 * t)
    x[:, 1] += 40 * np.sin(2 * np.pi * 0.0625 * t)
    x = x.astype(np.float32)
    prog = BatchedAutoNotch(1, 1, decimation=4096 * 2, device="cpu")
    ref = R.Notch(1, "cpu", decimation=4096 * 2)
    for lo in range(0, n, 8192):
        y = prog.process(x[None, lo:lo + 8192])[0]
        yr = ref.process(x[lo:lo + 8192])
        assert np.abs(y - yr).max() <= 1e-5 * np.abs(y).max()
    assert ref.slot[0] == prog.slot_i[0, 0] == 256


def test_noise_is_set_per_symbol():
    """Es/N0 is the traffic's esn0_db at the output's samples per symbol:
    noise power per sample = signal power x samples per symbol / Es/N0."""
    tr = dict(carriers=1, packets_per_loop=16, esn0_db=12.0,
              offset_center=0, offset_step=0.0, fractional_delay=False)
    clean = st.make_capture(dict(tr, esn0_db=300.0), 3, "cpu").iq
    noisy = st.make_capture(tr, 3, "cpu").iq
    ps = float(clean.square().sum(-1).mean())
    pn = float((noisy - clean).square().sum(-1).mean())
    assert abs(10 * np.log10(ps * st.INTERP / pn) - 12.0) < 0.05


@pytest.mark.parametrize("fmt", ["u8", "s16"])
def test_integer_formats_read_alike(fmt):
    """An integer capture is the float one scaled to `rms`, quantised;
    the reference's decode of its bytes equals the program's read_iq."""
    from leansdr_tpu_torch.util.iofmt import read_iq
    tr = dict(carriers=1, packets_per_loop=16, esn0_db=20.0,
              offset_center=0, offset_step=0.0, rms=30.0 if fmt == "u8"
              else 3000.0)
    f = st.make_capture(tr, 5, "cpu").iq[0].numpy()
    q = st.make_capture(dict(tr, format=fmt), 5, "cpu").iq[0].numpy()
    raw = q.tobytes()
    z = R.decode_iq(raw, fmt)
    assert np.array_equal(z, read_iq(raw, fmt))
    k = tr["rms"] / np.sqrt(np.mean(f.astype(np.float64) ** 2))
    assert np.abs(z - f * k).max() <= 0.5 + 1e-3 * tr["rms"]
