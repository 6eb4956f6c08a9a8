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
