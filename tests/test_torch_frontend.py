"""The port's matched filter (dsp/mf_prefilter.py) and symbol ring
append (fec/deconv_device.py) against their JAX counterparts.

Tolerances:
  * mf_prefilter: float32 with a different summation order (conv1d vs
    XLA's banded matmul at precision="highest"), and XLA's own cos/sin;
    max |delta| <= 1e-5 * max|y|.
  * deconv_append: exact. The ring below each channel's new fill, and
    the fill itself, must equal the JAX butterfly's; rows at or past the
    fill are garbage by contract in both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp import mf_prefilter as jmf
from leansdr_tpu.fec import deconv_device as jdd

from leansdr_tpu_torch.dsp import mf_prefilter as tmf
from leansdr_tpu_torch.fec import deconv_device as tdd


def test_mf_taps_match():
    assert tmf.make_mf_taps(4e6, 2e6, 0.35, 30) == \
        jmf.make_mf_taps(4e6, 2e6, 0.35, 30)


def test_mf_prefilter_matches_jax():
    rng = np.random.default_rng(11)
    taps = jmf.make_mf_taps(4e6, 2e6, 0.35, 30)
    C, n = 4, 2048
    x = (rng.normal(size=(C, n + len(taps) - 1, 2)) * 75).astype(np.float32)
    # Integer, fractional, negative and large carrier steps (u16/sample).
    freqw = np.array([0.0, 1234.56, -3071.25, 8191.9], np.float32)
    yj = np.asarray(jmf.mf_prefilter(taps, jnp.asarray(freqw),
                                     jnp.asarray(x)))
    yt = tmf.mf_prefilter(taps, torch.from_numpy(freqw),
                          torch.from_numpy(x)).numpy()
    assert yt.shape == yj.shape == (C, n, 2)
    err = np.abs(yt - yj).max()
    assert err <= 1e-5 * np.abs(yj).max(), err


class _Plan:
    def __init__(self, cap, store_costs):
        self.cap = cap
        self.store_costs = store_costs


def _append_both(plan, st, sym, valid, cost):
    """Run both appends on copies of `st` (numpy dict)."""
    js = jdd.deconv_append(plan, {k: jnp.asarray(v) for k, v in st.items()},
                           jnp.asarray(sym), jnp.asarray(valid),
                           None if cost is None else jnp.asarray(cost))
    ts = tdd.deconv_append(plan, {k: torch.from_numpy(v.copy())
                                  for k, v in st.items()},
                           torch.from_numpy(sym), torch.from_numpy(valid),
                           None if cost is None else torch.from_numpy(cost))
    return ({k: np.asarray(v) for k, v in js.items()},
            {k: v.numpy() for k, v in ts.items()})


def _check_ring(js, ts, keys):
    f = js["fill"]
    np.testing.assert_array_equal(ts["fill"], f)
    for k in keys:
        for c in range(f.shape[0]):
            a, b = js[k][:f[c], c], ts[k][:f[c], c]
            bad = np.nonzero(a != b)[0]
            assert not len(bad), (f"{k} channel {c} row {bad[0]}: "
                                  f"jax {a[bad[0]]} port {b[bad[0]]}")


@pytest.mark.parametrize("store_costs", [True, False])
def test_append_matches_jax_ring_contract(store_costs):
    """Three chunks of wildly different valid densities (drag events
    across chunks), ring compared below fill after every chunk."""
    rng = np.random.default_rng(42)
    C, n = 5, 1 << 12
    plan = jdd.make_plan("1/2", C, n, 2.0, store_costs=store_costs)
    st = {"buf": rng.integers(0, 4, (plan.cap, C)).astype(np.uint8),
          "fill": rng.integers(0, 200, C).astype(np.int32)}
    keys = ["buf"]
    if store_costs:
        st["cost"] = rng.integers(-32768, 0, (plan.cap, C)).astype(np.int16)
        keys.append("cost")
    for _ in range(3):
        sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
        valid = rng.random((n, C)) < rng.uniform(0.2, 0.9)
        cost = (rng.integers(-32768, 0, (n, C)).astype(np.int16)
                if store_costs else None)
        js, ts = _append_both(plan, st, sym, valid, cost)
        _check_ring(js, ts, keys)
        st = js


def test_append_drift_guard_protects_leaders():
    """A laggard more than DELTA_MAX behind the fleet is dragged forward;
    the in-window channels' rings stay exact."""
    assert tdd.DELTA_MAX == jdd.DELTA_MAX
    rng = np.random.default_rng(3)
    C, n = 3, 512
    plan = jdd.make_plan("1/2", C, n, omega=2.0)
    st = {"buf": rng.integers(0, 4, (plan.cap, C)).astype(np.uint8),
          "fill": np.array([1000, 1000 - (tdd.DELTA_MAX + 200), 990],
                           np.int32)}
    sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
    valid = rng.random((n, C)) < 0.5
    js, ts = _append_both(plan, st, sym, valid, None)
    _check_ring(js, ts, ["buf"])
    assert ts["fill"][1] == 1000 - (tdd.DELTA_MAX - 1) + valid[:, 1].sum()
    for c, start in ((0, 1000), (2, 990)):
        vs = sym[valid[:, c], c]
        np.testing.assert_array_equal(ts["buf"][start:start + len(vs), c],
                                      vs)


def test_append_cap_clamp():
    """Fills at the write-window limit: fill' = min(fill + nvalid,
    cap - DELTA_MAX - n), symbols past it are dropped."""
    rng = np.random.default_rng(9)
    C, n = 4, 1024
    cap = 8192
    plan = _Plan(cap, True)
    lim = cap - tdd.DELTA_MAX - n
    st = {"buf": rng.integers(0, 4, (cap, C)).astype(np.uint8),
          "cost": rng.integers(-32768, 0, (cap, C)).astype(np.int16),
          "fill": np.array([lim, lim - 100, lim - 200, lim - 5], np.int32)}
    sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
    valid = rng.random((n, C)) < 0.6
    cost = rng.integers(-32768, 0, (n, C)).astype(np.int16)
    js, ts = _append_both(plan, st, sym, valid, cost)
    assert (ts["fill"] == lim).all()
    _check_ring(js, ts, ["buf", "cost"])
