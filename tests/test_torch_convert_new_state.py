"""`leansdr_tpu_torch.convert` on JAX checkpoints that hold the state of
the paths slice 8 ported (ROADMAP queue 1 items 13 and 20): the Viterbi
decoders at nsyncs other than 4 and at the trellis rates new to the port
(single carrier: 8PSK on the 2/3 trellis, 16 replicas, and BPSK 1/2 on
the rate-1/2 ACS, 2 replicas; fleet: 8PSK decoded as 4/6, 32 replicas, in
JAX's CPU XLA layout, and BPSK 1/2 on the banked route in JAX's TPU
banked layout and in its XLA layout), and the single carrier's --cnr and
--fd-spectrum estimators as the JAX receiver writes them on the CPU (the
host blocks) and on an accelerator (the batched blocks behind CnrFft1 /
Spectrum1). Each converted checkpoint is loaded into a fresh port
receiver, which then continues beside the JAX one.

Tolerance: none for the decoders (bytes, discriminants, elected syncs and
trellis planes equal); the estimators' state (phase, backlog) equal and
their values within 1e-3 dB (tests/test_torch_cnr_spectrum.py).
"""

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.convert import (from_jax_checkpoint,
                                       from_jax_dvbs_checkpoint)
from leansdr_tpu_torch.dsp.cstln import Predef
from leansdr_tpu_torch.fec import viterbi_banked as tvb
from leansdr_tpu_torch.pipelines import dvbs_rx as TR
from leansdr_tpu_torch.pipelines import multi_rx as TM

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


def _symbols(nsym, nsymbols, C, seed):
    """Random hard symbols [nsym, C] u8 and soft costs (int16)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nsymbols, (nsym, C)).astype(np.uint8),
            -rng.integers(0, 100, (nsym, C)).astype(np.int16))


@pytest.mark.parametrize("name,rate,lanes", [("PSK8", "2/3", 16),
                                             ("BPSK", "1/2", 2)])
def test_single_carrier_viterbi_checkpoint(name, rate, lanes):
    """A JAX DvbsReceiver --viterbi whose decoder has run 5 chunks (its
    trellis state [S, 64] in natural order) is converted: the port's
    planes are JAX's (rate 1/2: metric and the low path word; 2/3:
    permuted to stored rows), and both decode the next 4 chunks to the
    same bytes and elected sync."""
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    kw = dict(rate=rate, viterbi=True, fastlock=True, anf=0, Fs=4e6,
              Fm=2e6)
    j = J.DvbsReceiver(J.RxConfig(constellation=JP[name], **kw))
    nsym = 128 * j.deconv.nshifts
    syms, costs = _symbols(9 * nsym + 5, 1 << {"PSK8": 3, "BPSK": 1}[name],
                           1, seed=3)
    syms, costs = syms[:, 0], costs[:, 0]
    j.deconv.process(syms[:5 * nsym + 3], costs[:5 * nsym + 3])
    t = TR.DvbsReceiver(TR.RxConfig(constellation=Predef[name],
                                    exact_lut=False, **kw), device="cpu")
    t.load_state(from_jax_dvbs_checkpoint(j.save_state()))
    jst = [np.asarray(a) for a in j.deconv._dev_state]      # [S, 64]
    keys = t.deconv.plane_keys
    assert t.deconv._dev_state[0].shape == (64, lanes)
    if rate == "1/2":
        want = {"metric": jst[0].T, "path": jst[2].view(np.int32).T}
    else:
        orig = tvb.bank_geometry(rate).orig
        want = dict(zip(keys, (a.view(np.int32).T[orig] for a in jst)))
    for k, v in zip(keys, t.deconv._dev_state):
        np.testing.assert_array_equal(want[k], v.numpy(), err_msg=k)
    a = j.deconv.process(syms[5 * nsym + 3:], costs[5 * nsym + 3:])
    b = t.deconv.process(syms[5 * nsym + 3:], costs[5 * nsym + 3:])
    assert len(b) > 0
    np.testing.assert_array_equal(a, b)
    assert t.deconv.current == j.deconv.current


@pytest.mark.parametrize("accelerator", [False, True])
def test_single_carrier_cnr_spectrum_checkpoint(accelerator):
    """A JAX DvbsReceiver with --cnr --fd-spectrum (Fs = 65536, Fm =
    16384) after 150000 samples of preprocessing, its estimators the host
    blocks (as on the CPU) or the batched ones behind CnrFft1 / Spectrum1
    (as on an accelerator): converted, the port's estimators hold JAX's
    phase, backlog and EMA'd power, and both go on to the same CNR
    values and spectrum lines."""
    from leansdr_tpu.dsp import blocks_device as jbd
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.pipelines import dvbs_rx as J
    kw = dict(Fs=65536.0, Fm=16384.0, anf=0, cnr=True, want_spectrum=True)
    j = J.DvbsReceiver(J.RxConfig(constellation=JP.QPSK, **kw))
    if accelerator:
        j.cnr_est = jbd.CnrFft1(0.25)
        j.cnr_est.decimation = 65536
        j.spectrum = jbd.Spectrum1()
        j.spectrum.decimation = 65536
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((300000, 2)) * 30).astype(np.float32)
    j._preprocess(x[:150000])
    t = TR.DvbsReceiver(TR.RxConfig(exact_lut=False, **kw), device="cpu")
    t.load_state(from_jax_dvbs_checkpoint(j.save_state()))
    assert t.meas["cnr"] == j.meas["cnr"] and len(t.meas["cnr"]) == 2
    for name in ("cnr_est", "spectrum"):
        jb, tb = getattr(j, name), getattr(t, name).b
        jb = jb.b if accelerator else jb
        assert tb.phase == jb.phase
        bl = (jb.backlog.buf if accelerator else
              np.stack([jb.backlog.real, jb.backlog.imag], -1)[None])
        np.testing.assert_array_equal(bl, tb.backlog.buf)
        np.testing.assert_allclose(tb.avgpower.reshape(-1),
                                   np.asarray(jb.avgpower).reshape(-1),
                                   rtol=1e-6)
    j._preprocess(x[150000:])
    t._preprocess(x[150000:])
    assert len(t.meas["cnr"]) == len(j.meas["cnr"]) == 4
    np.testing.assert_allclose(t.meas["cnr"], j.meas["cnr"], atol=1e-3)
    assert len(t.spectrum_lines) == 2 == len(j.spectrum_lines) - 2
    np.testing.assert_allclose(np.array(t.spectrum_lines),
                               np.array(j.spectrum_lines[2:]), atol=1e-3)


def _fleet_pair(name, rate, C, banked):
    from leansdr_tpu.dsp.cstln import Predef as JP
    from leansdr_tpu.fec import viterbi_device as jvd
    from leansdr_tpu.pipelines import dvbs_rx as J
    from leansdr_tpu.pipelines import multi_rx as JMr
    kw = dict(rate=rate, viterbi=True, fastlock=True, Fs=4e6, Fm=2e6)
    j = JMr.MultiDvbsReceiver(J.RxConfig(constellation=JP[name], **kw), C,
                              chunk_samples=1 << 12)
    if banked:
        # The JAX fleet's route on an accelerator: the banked kernel
        # (interpret mode here), its [64, 128-lane] planes.
        j.deconv = jvd.MultiViterbiSync(j.cstln, j.rate, C, 1 << 12,
                                        j.omega, banked=True,
                                        interpret=True)
    t = TM.MultiDvbsReceiver(TR.RxConfig(constellation=Predef[name],
                                         exact_lut=False, **kw), C,
                             chunk_samples=1 << 12, device="cpu")
    return j, t


@pytest.mark.parametrize("name,rate,banked", [("PSK8", "2/3", False),
                                              ("BPSK", "1/2", False),
                                              ("BPSK", "1/2", True)])
def test_fleet_viterbi_checkpoint(name, rate, banked):
    """A JAX fleet (2 carriers) whose decoder has run one decode is
    converted with its rate and constellation (8PSK 2/3: the 4/6
    trellis, 32 replicas; BPSK 1/2: 2 replicas on the banked route, its
    planes path_hi and path_lo at rate 1/2), from JAX's XLA layout [C*S,
    64] u32 or its banked [64, 128] i32: the port's planes are JAX's,
    and both decode the next one to the same bytes, discriminants and
    elected syncs (from the banked layout, the bytes against JAX's XLA
    decoder from the same state: JAX's banked kernel takes the wrong
    path bit at rate 1/2). Without the constellation the planes' layout
    gives the conversion away."""
    import jax.numpy as jnp
    C = 2
    j, t = _fleet_pair(name, rate, C, banked)
    assert j.deconv.banked == banked and j.deconv.xla != banked
    need = j.deconv.plan.needed
    syms, costs = _symbols(2 * need, 1 << {"PSK8": 3, "BPSK": 1}[name], C,
                           seed=5)
    valid = np.ones(syms.shape, bool)
    half = need + 1
    j.deconv.append(jnp.asarray(syms[:half]), jnp.asarray(valid[:half]),
                    jnp.asarray(costs[:half]))
    j.deconv.decode()
    blob = j.save_state()
    if name == "BPSK":
        with pytest.raises(ValueError, match="constellation"):
            from_jax_checkpoint(blob, rate=rate)
    t.load_state(from_jax_checkpoint(blob, rate=rate,
                                     constellation=Predef[name]))
    S = t.deconv.plan.nsyncs
    assert S == {"PSK8": 32, "BPSK": 2}[name]
    orig = tvb.bank_geometry(t.rate).orig
    for k in ("metric", "path_hi", "path_lo"):
        v = np.asarray(j.deconv.state[k])
        want = v[:, :C * S] if banked else v.view(np.int32).T[orig]
        np.testing.assert_array_equal(want, t.deconv.state[k].numpy(),
                                      err_msg=k)
    decs = [j.deconv]
    if banked:
        # JAX's banked kernel reads the decision at rate 1/2 from the
        # wrong path bit (leansdr_tpu/fec/viterbi_banked.py:377, 416:
        # sh = -1; ROADMAP queue 3): its bytes are held against JAX's XLA
        # decoder from the same state, its other outputs against itself.
        from leansdr_tpu.fec import viterbi_device as jvd
        x = jvd.MultiViterbiSync(j.cstln, j.rate, C, 1 << 12, j.omega,
                                 banked=False)
        rho = tvb.bank_geometry(t.rate).rho
        x.state = dict(j.deconv.state, **{k: jnp.asarray(np.ascontiguousarray(
            np.asarray(j.deconv.state[k])[:, :C * S][rho].T).view(
                np.int32 if k == "metric" else np.uint32))
            for k in ("metric", "path_hi", "path_lo")})
        decs.append(x)
    for d in decs:
        d.append(jnp.asarray(syms[half:]), jnp.asarray(valid[half:]),
                 jnp.asarray(costs[half:]))
    t.deconv.append(torch.from_numpy(syms[half:]),
                    torch.from_numpy(valid[half:]),
                    torch.from_numpy(costs[half:]))
    outs = [d.decode() for d in decs]
    got = t.deconv.decode()
    for i, nm in enumerate(("bytes", "discr", "under")):
        want = outs[-1 if nm == "bytes" else 0][i]
        np.testing.assert_array_equal(np.asarray(want), got[i].numpy(),
                                      err_msg=nm)
    np.testing.assert_array_equal(np.asarray(j.deconv.state["current"]),
                                  t.deconv.state["current"].numpy())
