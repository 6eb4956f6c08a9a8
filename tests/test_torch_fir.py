"""The port's FIR module (leansdr_tpu_torch/dsp/fir_kernel.py): `cfir_ref`
and `fir_ref`, the plain versions of csrc/fir.cu, against the JAX Pallas
kernels `cfir_pallas` / `fir_pallas` in interpret mode, and the streaming
`FirFilterDevice` against JAX's across chunks, decimation and a
mid-stream carrier retune.

Tolerance: 2e-4 * max|x| for the kernels' outputs (float32 sums of up to
nt products in the same order; XLA may contract multiply-adds, PyTorch
rounds each operation); the streaming filter's outputs 2e-4 * max|x| as
well. The re-modulated taps are computed on the host in float64 and cast
to float32 on both sides, so they are equal bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from leansdr_tpu.dsp import fir_pallas as jfir

from leansdr_tpu_torch.dsp import fir_kernel as tfir

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)


def _planes(rng, rows, n, head_zeros=0):
    x = rng.normal(size=(rows, n)).astype(np.float32) * 30
    x[:, :head_zeros] = 0
    return x


@pytest.mark.parametrize("nt,n,head", [(21, 3 * 2048, 0), (79, 2 * 2048, 500)])
def test_cfir_ref_matches_jax_kernel(nt, n, head):
    """Complex taps from a stream head (zeros before it) and from
    mid-stream (no leading zeros), short and long filters; the port also
    takes lengths that are not block multiples (checked against its own
    output on the padded length)."""
    rng = np.random.default_rng(nt)
    x = _planes(rng, 2, n, head)
    tr = rng.normal(size=nt).astype(np.float32)
    ti = rng.normal(size=nt).astype(np.float32)
    want = np.asarray(jfir.cfir_pallas(jnp.asarray(x), jnp.asarray(tr),
                                       jnp.asarray(ti), nt, interpret=True))
    got = tfir.cfir(torch.from_numpy(x), torch.from_numpy(tr),
                    torch.from_numpy(ti)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(x).max())
    m = n - 777                       # ragged length: a causal prefix
    part = tfir.cfir_ref(torch.from_numpy(x[:, :m]), torch.from_numpy(tr),
                         torch.from_numpy(ti)).numpy()
    np.testing.assert_array_equal(part, got[:, :m])


def test_cfir_ref_longest_filter_matches_convolve():
    """nt = 2048, the most taps the kernel's shared memory holds (the JAX
    kernel's limit too; its interpret mode would unroll 2048 steps, so
    the reference here is np.convolve in float64), at a length that is
    not a block multiple."""
    rng = np.random.default_rng(2048)
    nt, n = 2048, 2 * 2048 + 333
    x = _planes(rng, 2, n)
    taps = (rng.normal(size=nt) + 1j * rng.normal(size=nt)) / np.sqrt(nt)
    tr, ti = taps.real.astype(np.float32), taps.imag.astype(np.float32)
    got = tfir.cfir(torch.from_numpy(x), torch.from_numpy(tr),
                    torch.from_numpy(ti)).numpy()
    want = np.convolve(x[0] + 1j * x[1], tr + 1j * ti.astype(np.float64))[:n]
    np.testing.assert_allclose(got[0] + 1j * got[1], want, rtol=0,
                               atol=2e-4 * np.abs(x).max())


@pytest.mark.parametrize("nt", [21, 79])
def test_fir_ref_matches_jax_kernel(nt):
    """Real taps on 8 rows (the zero-imaginary case of the same kernel)."""
    rng = np.random.default_rng(100 + nt)
    x = _planes(rng, 8, 2 * 2048)
    taps = rng.normal(size=nt).astype(np.float32)
    want = np.asarray(jfir.fir_pallas(jnp.asarray(x),
                                      tuple(float(t) for t in taps),
                                      interpret=True))
    got = tfir.fir(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(x).max())
    # fir_ref is cfir_ref with zero imaginary taps, row pair by row pair.
    c = tfir.cfir_ref(torch.from_numpy(x[:2]), torch.from_numpy(taps),
                      torch.zeros(nt)).numpy()
    np.testing.assert_array_equal(c[0], got[0])


def test_fir_filter_device_matches_jax():
    """Streaming --resample filter: the port's FirFilterDevice against
    JAX's over uneven chunks, decimation 7 and two carrier retunes (one
    inside freq_tol, which must not retune); taps bit-equal after each."""
    from leansdr_tpu.dsp import filtergen
    rng = np.random.default_rng(7)
    coeffs = filtergen.lowpass(78, 0.025)
    j = jfir.FirFilterDevice(coeffs, decim=7, freq_tol=0.002,
                             interpret=True)
    t = tfir.FirFilterDevice(coeffs, decim=7, freq_tol=0.002, device="cpu")
    n = 3 * 4096 + 1234
    z = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 40
         ).astype(np.complex64)
    cuts = [0, 5, 2100, 4096 + 2100, 9000, n]
    taps = [None, 0.0, 0.011, 0.0115, -0.02]
    outs_j, outs_t = [], []
    for (a, b), f in zip(zip(cuts[:-1], cuts[1:]), taps):
        outs_j.append(j.process(z[a:b], f))
        outs_t.append(t.process(z[a:b], f))
        np.testing.assert_array_equal(np.asarray(j.taps_r),
                                      t.taps_r.numpy())
        np.testing.assert_array_equal(np.asarray(j.taps_i),
                                      t.taps_i.numpy())
        assert j.current_freq == t.current_freq
        np.testing.assert_array_equal(j.hist, t.hist)
    assert t.current_freq == -0.02
    oj, ot = np.concatenate(outs_j), np.concatenate(outs_t)
    assert len(oj) == len(ot) > 1500
    np.testing.assert_allclose(ot, oj, rtol=0,
                               atol=2e-4 * np.abs(z).max())


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor the wrappers run the plain version (and launch
    nothing); taps beyond the kernel's shared-memory budget are refused
    on the card before any launch."""
    x = torch.ones((2, 10))
    w = torch.ones(3)
    before = (tfir.cfir.launches, tfir.fir.launches)
    assert torch.equal(tfir.cfir(x, w, w), tfir.cfir_ref(x, w, w))
    assert torch.equal(tfir.fir(x, w), tfir.fir_ref(x, w))
    assert (tfir.cfir.launches, tfir.fir.launches) == before
    with pytest.raises(ValueError, match="taps"):
        tfir._check_taps(tfir.MAX_TAPS + 1)
