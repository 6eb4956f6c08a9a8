"""The port's FIR module (leansdr_tpu_torch/dsp/fir_kernel.py): `cfir_ref`
and `fir_ref`, the plain versions of csrc/fir.cu, against the JAX Pallas
kernels `cfir_pallas` / `fir_pallas` in interpret mode, cfir's decimated
contract (start, step, count) against slicing its full output, and the
streaming `FirFilterDevice` against JAX's across chunks, decimation and a
mid-stream carrier retune.

The JAX side runs in one child process for the whole module, with
multiply-add contraction off in XLA (XLA_FLAGS=--xla_cpu_max_isa=AVX: no
FMA instructions), so both sides round each product and sum once in the
same order, as the CUDA kernel (built with --fmad=false) does.

Tolerance: none against JAX. Every output is equal bit for bit; the
re-modulated taps are computed on the host in float64 and cast to
float32 on both sides. The longest filter (2048 taps) is held against
np.convolve in float64 within 2e-4 * max|x| (float32 sums of 2048
products).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp import fir_kernel as tfir

# Single-threaded torch: the plain versions run many small ops, which
# OpenMP threads only slow down, most of all beside other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FMA_OFF = "--xla_cpu_max_isa=AVX"
CFIR_CASES = ((21, 3 * 2048, 0), (79, 2 * 2048, 500))
FIR_TAPS = (21, 79)
# The streaming filter: chunk boundaries and the carrier tap per chunk
# (None keeps it; 0.0115 is inside freq_tol of 0.011 and must not retune).
STREAM_CUTS = (0, 5, 2100, 4096 + 2100, 9000, 3 * 4096 + 1234)
STREAM_TAPS = (None, 0.0, 0.011, 0.0115, -0.02)


def _planes(rng, rows, n, head_zeros=0):
    x = rng.normal(size=(rows, n)).astype(np.float32) * 30
    x[:, :head_zeros] = 0
    return x


def _cfir_case(nt, n, head):
    rng = np.random.default_rng(nt)
    x = _planes(rng, 2, n, head)
    return (x, rng.normal(size=nt).astype(np.float32),
            rng.normal(size=nt).astype(np.float32))


def _fir_case(nt):
    rng = np.random.default_rng(100 + nt)
    return _planes(rng, 8, 2 * 2048), rng.normal(size=nt).astype(np.float32)


def _stream():
    """(coeffs, complex64 stream) of the streaming-filter test."""
    from leansdr_tpu_torch.dsp import filtergen
    rng = np.random.default_rng(7)
    n = STREAM_CUTS[-1]
    z = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 40
         ).astype(np.complex64)
    return filtergen.lowpass(78, 0.025), z


def _jax_outputs() -> dict:
    """Every JAX output the module compares with. Runs in the child
    process (see jax_side)."""
    import jax.numpy as jnp
    from leansdr_tpu.dsp import fir_pallas as jfir
    out = {}
    for nt, n, head in CFIR_CASES:
        x, tr, ti = _cfir_case(nt, n, head)
        out["cfir", nt] = np.asarray(jfir.cfir_pallas(
            jnp.asarray(x), jnp.asarray(tr), jnp.asarray(ti), nt,
            interpret=True))
    for nt in FIR_TAPS:
        x, taps = _fir_case(nt)
        out["fir", nt] = np.asarray(jfir.fir_pallas(
            jnp.asarray(x), tuple(float(t) for t in taps), interpret=True))
    coeffs, z = _stream()
    j = jfir.FirFilterDevice(coeffs, decim=7, freq_tol=0.002,
                             interpret=True)
    steps = []
    for a, b, f in zip(STREAM_CUTS[:-1], STREAM_CUTS[1:], STREAM_TAPS):
        y = j.process(z[a:b], f)
        steps.append((y, np.asarray(j.taps_r), np.asarray(j.taps_i),
                      j.current_freq, j.hist.copy()))
    out["stream"] = steps
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """_jax_outputs() in one child process with FMA contraction off in
    XLA."""
    dst = tmp_path_factory.mktemp("jax_fir") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FMA_OFF}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    r = subprocess.run([sys.executable, __file__, str(dst)], env=env,
                       cwd=str(REPO), capture_output=True, timeout=600)
    assert r.returncode == 0, r.stdout.decode()[-4000:] + \
        r.stderr.decode()[-4000:]
    return pickle.loads(dst.read_bytes())


@pytest.mark.parametrize("nt,n,head", CFIR_CASES)
def test_cfir_ref_matches_jax_kernel(nt, n, head, jax_side):
    """Complex taps from a stream head (zeros before it) and from
    mid-stream (no leading zeros), short and long filters; the port also
    takes lengths that are not block multiples (checked against its own
    output on the padded length)."""
    x, tr, ti = _cfir_case(nt, n, head)
    got = tfir.cfir(torch.from_numpy(x), torch.from_numpy(tr),
                    torch.from_numpy(ti)).numpy()
    np.testing.assert_array_equal(got, jax_side["cfir", nt])
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


@pytest.mark.parametrize("start,step,count", [
    (0, 1, None), (79, 7, None), (79, 7, 1), (79, 7, 300), (5, 3, 1001),
    (0, 128, 32), (3000, 1, 97), (4095, 5, 1), (0, 1, 0)])
def test_cfir_decimated_outputs_are_the_full_outputs_sliced(start, step,
                                                            count):
    """cfir at t = start + j*step, j < count: the full-rate output sliced
    (count None: every t < n from start; ragged counts that end off any
    tile; one output; none)."""
    x, tr, ti = (torch.from_numpy(a) for a in _cfir_case(79, 4096, 0))
    full = tfir.cfir_ref(x, tr, ti)
    got = tfir.cfir(x, tr, ti, start=start, step=step, count=count)
    want = full[:, start::step]
    want = want if count is None else want[:, :count]
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("start,step,count", [
    (-1, 1, None), (0, 0, None), (4096, 1, 1), (0, 7, 587), (0, 1, -1)])
def test_cfir_refuses_outputs_past_the_input(start, step, count):
    """start < 0, step < 1, a negative count, or an output past the last
    input sample is refused before any launch."""
    x, tr, ti = (torch.from_numpy(a) for a in _cfir_case(21, 4096, 0))
    with pytest.raises(ValueError, match="start"):
        tfir.cfir(x, tr, ti, start=start, step=step, count=count)


@pytest.mark.parametrize("nt", FIR_TAPS)
def test_fir_ref_matches_jax_kernel(nt, jax_side):
    """Real taps on 8 rows (the zero-imaginary case of the same kernel)."""
    x, taps = _fir_case(nt)
    got = tfir.fir(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_array_equal(got, jax_side["fir", nt])
    # fir_ref is cfir_ref with zero imaginary taps, row pair by row pair.
    c = tfir.cfir_ref(torch.from_numpy(x[:2]), torch.from_numpy(taps),
                      torch.zeros(nt)).numpy()
    np.testing.assert_array_equal(c[0], got[0])


def test_fir_filter_device_matches_jax(jax_side):
    """Streaming --resample filter: the port's FirFilterDevice (one
    decimated cfir per chunk) against JAX's (the full-rate kernel and a
    gather) over uneven chunks, decimation 7 and two carrier retunes (one
    inside freq_tol, which must not retune): outputs, taps, tracked
    carrier and history equal after each chunk."""
    coeffs, z = _stream()
    t = tfir.FirFilterDevice(coeffs, decim=7, freq_tol=0.002, device="cpu")
    outs = []
    for (a, b, f), (yj, trj, tij, fj, hj) in zip(
            zip(STREAM_CUTS[:-1], STREAM_CUTS[1:], STREAM_TAPS),
            jax_side["stream"]):
        y = t.process(z[a:b], f)
        np.testing.assert_array_equal(y, yj)
        np.testing.assert_array_equal(trj, t.taps_r.numpy())
        np.testing.assert_array_equal(tij, t.taps_i.numpy())
        assert fj == t.current_freq
        np.testing.assert_array_equal(hj, t.hist)
        outs.append(y)
    assert t.current_freq == -0.02
    assert len(np.concatenate(outs)) > 1500


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor the wrappers run the plain version (and launch
    nothing); taps beyond the kernel's shared-memory budget are refused
    on the card before any launch."""
    x = torch.ones((2, 10))
    w = torch.ones(3)
    before = (tfir.cfir.launches, tfir.fir.launches)
    assert torch.equal(tfir.cfir(x, w, w), tfir.cfir_ref(x, w, w))
    assert torch.equal(tfir.cfir(x, w, w, 2, 3),
                       tfir.cfir_ref(x, w, w, 2, 3))
    assert torch.equal(tfir.fir(x, w), tfir.fir_ref(x, w))
    assert (tfir.cfir.launches, tfir.fir.launches) == before
    with pytest.raises(ValueError, match="taps"):
        tfir._check_taps(tfir.MAX_TAPS + 1)



def _fir_tile_model(x, taps, threads=128, opt=4):
    """NumPy float32 model of csrc/fir.cu's real-tap kernel: tiles of
    threads*opt outputs per row, each thread `opt` consecutive outputs;
    the tile's span staged from ntp (taps padded to a multiple of 4)
    samples before its first output, zeros before the stream head and
    past n; per group of 4 taps one 4-sample load slides the window
    (the upper 4 samples are the previous group's lower 4); taps past
    the last full group one at a time; every product and sum rounded
    once, in tap order."""
    R, n = x.shape
    nt = len(taps)
    ntp = -(-nt // 4) * 4
    tile = threads * opt
    ntiles = -(-n // tile)
    tp = np.zeros(ntp, np.float32)
    tp[:nt] = taps
    idx = (np.arange(ntiles)[:, None] * tile - ntp
           + np.arange(ntp + tile)[None, :])
    xs = np.where((idx >= 0) & (idx < n), x[:, idx.clip(0, n - 1)],
                  np.float32(0))                      # [R, tiles, span]
    A = opt * np.arange(threads) + ntp
    acc = np.zeros((R, ntiles, threads, opt), np.float32)
    hi = xs[:, :, A[:, None] + np.arange(4)]          # [R, tiles, th, 4]
    for g in range(nt // 4):
        lo = xs[:, :, A[:, None] - 4 * g - 4 + np.arange(4)]
        for i in range(4):
            for u in range(opt):
                v = hi[..., u - i] if u >= i else lo[..., 4 + u - i]
                acc[..., u] = acc[..., u] + tp[4 * g + i] * v
        hi = lo
    for k in range(4 * (nt // 4), nt):
        for u in range(opt):
            acc[..., u] = acc[..., u] + tp[k] * xs[:, :, A + u - k]
    return acc.reshape(R, ntiles * tile)[:, :n]


@pytest.mark.parametrize("nt", [1, 3, 4, 21, 65, 79])
def test_fir_kernel_tiling_model_matches_ref(nt):
    """The kernel's tiling (row, tile and ragged-edge offsets, 4 outputs
    per thread, the 4-tap window and the tap remainder) equals fir_ref
    bit for bit: rows of 1, 511, 512, 513 and 1500 samples (one tile's
    edges, and a partial last tile), from a zero stream head."""
    rng = np.random.default_rng(nt)
    taps = (rng.standard_normal(nt) / np.sqrt(nt)).astype(np.float32)
    for n in (1, 511, 512, 513, 1500):
        x = (40 * rng.standard_normal((3, n))).astype(np.float32)
        want = tfir.fir_ref(torch.from_numpy(x), torch.from_numpy(taps))
        got = _fir_tile_model(x, taps)
        assert np.array_equal(got, want.numpy()), (nt, n)


if __name__ == "__main__":
    # The JAX side of jax_side: python test_torch_fir.py OUT.pkl
    Path(sys.argv[1]).write_bytes(pickle.dumps(_jax_outputs()))
