"""The port's hard-decision decode (leansdr_tpu_torch.fec.deconv_device:
DeconvPlan, deconv_decode, DeviceDeconvolver) against the JAX package's
(leansdr_tpu/fec/deconv_device.py), on the CPU.

Tolerance: none. Everything compared is integer: decoded bytes, the
elected hypothesis' disagreement counts, underflow flags, the ring, fill
and locked hypotheses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leansdr_tpu.fec import deconv_device as J

from leansdr_tpu_torch.fec import convenc, deconv
from leansdr_tpu_torch.fec import deconv_device as T
from leansdr_tpu_torch.fec.viterbi_device import decoder

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

RATES = ("1/2", "4/6", "3/4", "5/6", "7/8")


def _apply_sync_transform(syms: np.ndarray, sync_id: int) -> np.ndarray:
    """Remap TX symbols so hypothesis map `sync_id` is the one that
    decodes (tests/test_deconv_device.py)."""
    maps = deconv.sync_maps()
    inv = np.zeros(4, np.uint8)
    for s_rx in range(4):
        inv[maps[sync_id, s_rx]] = s_rx
    return inv[maps[0, syms]]


def _ring(rate, fastlock, seed=11):
    """One numpy-seeded ring of 4 channels for both sides: channels 0-2
    carry the encoder's output under sync maps 1, 2, 3 with symbol slips
    0, A-1, 1 % A; channel 3 random symbols. Channel 2 holds one symbol
    fewer than a decode needs (it underflows). Random locked hypotheses
    (the non-fastlock election)."""
    rng = np.random.default_rng(seed)
    C = 4
    plan = T.make_plan(rate, C, 2048, 1.0, fastlock, sub_symbols=256)
    A, need = plan.A, plan.needed
    n = 2 * plan.consumed + need
    bits_in = convenc.FEC_SPECS[rate][0]
    nbytes = -(-n * 2 // 8 // bits_in) * bits_in + 2 * bits_in
    syms, _ = convenc.encode(rng.integers(0, 256, nbytes, dtype=np.uint8),
                             rate, 2)
    buf = np.zeros((plan.cap, C), np.uint8)
    for c, (s, slip) in enumerate(((1, 0), (2, A - 1), (3, 1 % A))):
        buf[:n, c] = _apply_sync_transform(syms, s)[slip:slip + n]
    buf[:n, 3] = rng.integers(0, 4, n)
    fill = np.array([n, n - 5, need - 1, n], np.int32)
    locked = rng.integers(0, 4 * A, C).astype(np.int32)
    return plan, dict(buf=buf, fill=fill, locked=locked)


@pytest.mark.parametrize("fastlock", [True, False],
                         ids=["fastlock", "locked"])
@pytest.mark.parametrize("rate", RATES)
def test_deconv_decode_matches_jax(rate, fastlock):
    """Two decodes in a row from the same ring on both sides: the plans'
    geometry, bytes, elected counts, underflow flags, the advanced ring,
    fill and locked are equal; the port's decode is what
    viterbi_device.decoder("deconv") returns."""
    plan, st = _ring(rate, fastlock)
    jplan = J.make_plan(rate, 4, 2048, 1.0, fastlock, sub_symbols=256)
    for k in ("P_sub", "E", "cap", "A", "consumed", "needed", "nbytes"):
        assert getattr(plan, k) == getattr(jplan, k), k
    assert decoder("deconv") is T.deconv_decode
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    for call in range(2):
        js, jb, je, ju = J.deconv_decode(jplan, js)
        ts, tb, te, tu = T.deconv_decode(plan, ts)
        for what, a, b in (("bytes", jb, tb), ("errs", je, te),
                           ("underflow", ju, tu)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"call {call} {what}")
        for k in ("buf", "fill", "locked"):
            np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                          err_msg=f"call {call} {k}")
        assert tb.dtype == torch.uint8 and te.dtype == torch.int32
    assert bool(tu[2]) and not bool(tu[0])      # channel 2 underflowed


@pytest.mark.parametrize("rate", ["1/2", "3/4", "5/6", "7/8", "4/6"])
def test_device_deconv_inverts_encoder(rate):
    """tests/test_deconv_device.py:45 on the port: the ring + the
    all-hypothesis decode + the election invert the TX encoder at every
    rate, under sync rotations/conjugation and symbol slips, with every
    4th sample invalid (compaction)."""
    rng = np.random.default_rng(7)
    spec = deconv.deconv_spec(rate)
    data = rng.integers(0, 256, 5880, dtype=np.uint8)
    dbits = np.unpackbits(data)
    needle = dbits[9000:9400]
    syms, _ = convenc.encode(data, rate, 2)
    C = 4
    # Rate 5/6 cannot tell conjugation apart by the disagreement count
    # (as in the reference's fastlock election): direct maps only.
    syncsel = [0, 1, 2, 3] if rate != "5/6" else [0, 1, 0, 1]
    slips = [0, 1 % max(1, spec.punctweight // 2), 0,
             (spec.punctweight // 2) - 1]
    n = len(syms) - max(slips) - 4
    sym_tc = np.stack([_apply_sync_transform(syms, syncsel[c])
                       [slips[c]:slips[c] + n] for c in range(C)], axis=1)
    expanded = np.zeros((n + n // 3, C), np.uint8)
    vmask = np.ones((n + n // 3, C), bool)
    vmask[::4] = False
    pos = np.cumsum(vmask[:, 0]) - 1
    take = vmask[:, 0]
    expanded[take] = sym_tc[pos[take]]
    nsamp = expanded.shape[0]
    dd = T.DeviceDeconvolver(rate, C, nsamp, omega=float(nsamp) / n,
                             fastlock=True, sub_symbols=1024, device="cpu")
    dd.append(torch.from_numpy(expanded), torch.from_numpy(vmask))
    dd.note_production(n)
    outs = [[] for _ in range(C)]
    while dd.can_decode():
        by, errs, under = dd.decode()
        assert not under.any()
        for c in range(C):
            outs[c].append(by[c].numpy())
    for c in range(C):
        assert outs[c], "no decode happened"
        full = np.concatenate(outs[c])
        found = False
        for inv in (0, 1):
            b = np.unpackbits(full) ^ inv
            w = np.lib.stride_tricks.sliding_window_view(b, len(needle))
            found |= bool((w == needle).all(axis=1).any())
        assert found, f"channel {c} failed to invert"


@pytest.mark.parametrize("rate", ["1/2", "3/4", "7/8"])
def test_next_sync_rotation_order(rate):
    """next_sync's rotation, then slip, order against the JAX
    DeviceDeconvolver: 4 channels, a fixed pattern of calls (several per
    channel between applications, up to past a full cycle of 4 * A).
    The port queues each call and applies the queue, in order, at the
    next apply_pending_transition (dispatch and decode call it first);
    until then `locked` is unchanged."""
    C = 4
    j = J.DeviceDeconvolver(rate, C, 4096, 2.0, fastlock=False)
    t = T.DeviceDeconvolver(rate, C, 4096, 2.0, fastlock=False,
                            device="cpu")
    A = t.plan.A
    assert A == j.plan.A
    rounds = [[0], [1, 1], [2] * 5, [0, 3, 3, 1], [3] * (4 * A + 3)]
    for calls in rounds:
        before = t.state["locked"].clone()
        for c in calls:
            j.next_sync(c)
            t.next_sync(c)
        assert torch.equal(t.state["locked"], before)
        t.apply_pending_transition()
        np.testing.assert_array_equal(np.asarray(j.state["locked"]),
                                      t.state["locked"].numpy())
    assert t.state["locked"].dtype == torch.int32
    t.apply_pending_transition()                 # empty queue: no change
    np.testing.assert_array_equal(np.asarray(j.state["locked"]),
                                  t.state["locked"].numpy())


def test_deconv_kernel_is_the_jax_kernel():
    """The conv1d weight is the JAX int8 kernel [TB, 1, 2pp] transposed,
    at every rate."""
    for rate in RATES:
        np.testing.assert_array_equal(
            T._deconv_kernel(rate).transpose(2, 1, 0),
            J._deconv_kernel(rate).astype(np.float32))
