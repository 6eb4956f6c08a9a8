"""What the two scan-demod kernels' shared-memory layouts rely on, held on
the CPU (the kernels themselves run only on the card, where chip_smoke.py
holds them bit for bit against their plain versions).

csrc/hs_demod.cu keeps the polar angle plane and the reachable rect
entries in shared memory and reads each sample's polar word from a ring
that the wrapper's bulk gather fills:
  * every polar radius is at most 181, so the rect column r >> 1 is at
    most 90 and the packed u16 plane `rect16` (rect_re | rect_im << 8 at
    (r >> 1) * 256 + a) holds every reachable entry: exhaustive over the
    256 angles x 91 columns;
  * the kernel's index arithmetic on a polar word, ((q >> 17) << 8) + a,
    reads from rect16 the pair the plain version gathers at a * 256 +
    (r >> 1), for every polar word and every angle a;
  * `polar_words` equals the plain version's pa[flat] and pr[flat].
csrc/scan_demod.cu (one channel per block) keeps the rrc shifted
coefficients in shared memory beside the input ring where they fit:
`smem_bytes` and `taps_in_shared` for the CLI's geometries (4 and 2.4
Msps: 16 and 10 taps, the byte counts the source states) and for
geometries past them.

Tolerance: none (integer tables and byte counts).
"""

import numpy as np
import pytest
import torch

from leansdr_tpu_torch.dsp import receiver as T
from leansdr_tpu_torch.dsp import receiver_hs as H
from leansdr_tpu_torch.pipelines.dvbs_rx import RxConfig, rrc_sampler

# Single-threaded torch, as in every port test file.
torch.set_num_threads(1)


def _rect16():
    return H.hs_tables("cpu")["rect16"].numpy().view(np.uint16).astype(
        np.int64)


def test_polar_radius_bound():
    tab = H._tables_np()
    r = tab["polar_r"]
    assert r.max() == 181 and (r >> 1).max() == H.RECT_COLS - 1


def test_rect16_holds_every_reachable_entry():
    tab = H._tables_np()
    packed = _rect16()
    assert packed.shape == (H.RECT_COLS * 256,)
    a = np.arange(256)[:, None]
    rh = np.arange(H.RECT_COLS)[None, :]
    want_re = tab["rect_re"][a * 256 + rh]
    want_im = tab["rect_im"][a * 256 + rh]
    got = packed[rh * 256 + a]
    np.testing.assert_array_equal(got & 0xFF, want_re)
    np.testing.assert_array_equal(got >> 8, want_im)


def test_kernel_rect_index_matches_plain_gather():
    """For every polar word q the tables hold and every u8 angle a: the
    kernel's ((q >> 17) << 8) + a on rect16 gives the plain version's
    rect_re and rect_im at a * 256 + (r >> 1)."""
    t = H.hs_tables("cpu")
    tab = H._tables_np()
    q = np.unique(t["polar_w"].numpy().astype(np.int64))
    r = q >> 16
    assert (q >= 0).all() and r.max() == 181
    a = np.arange(256)[None, :]
    got = _rect16()[((q[:, None] >> 17) << 8) + a]
    plain = a * 256 + (r[:, None] >> 1)
    np.testing.assert_array_equal(got & 0xFF, tab["rect_re"][plain])
    np.testing.assert_array_equal(got >> 8, tab["rect_im"][plain])


@pytest.mark.parametrize("C", [1, 37])
def test_polar_words_match_plain_gathers(C):
    """The wrapper's [nsamp+1, C] polar words unpack to the plain
    version's pa[flat] (sign-extended i16) and pr[flat]."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 256, (C, 2 * H.CHUNK + 1, 2),
                                      dtype=np.int32))
    t = H.hs_tables("cpu")
    w = H.polar_words(t, x)
    assert w.dtype == torch.int32 and w.shape == (2 * H.CHUNK + 1, C)
    assert w.is_contiguous()
    flat = ((x[:, :, 0] * 256 + x[:, :, 1]) & 0xFFFF).to(torch.int64)
    ang = ((w.T & 0xFFFF) ^ 0x8000) - 0x8000
    assert torch.equal(ang, t["polar_a"][flat])
    assert torch.equal(w.T >> 16, t["polar_r"][flat])


def test_hs_shared_memory_fits():
    """The byte count csrc/hs_demod.cu states: polar angles, rect16, the
    two-stage ring of CHUNK + 1 polar words and the word tile for 32
    channels."""
    t = H.hs_tables("cpu")
    nbytes = (t["polar_a16"].numel() * 2 + t["rect16"].numel() * 2
              + 2 * (H.CHUNK + 1) * 32 * 4 + H.CHUNK * 32 * 4)
    assert nbytes == 227072 <= T.SMEM_LIMIT


def _rrc_params(fs, **fields):
    co, steps = rrc_sampler(fs, RxConfig(Fs=fs, Fm=2e6, **fields))
    return T.ReceiverParams(omega=fs / 2e6, sampler="rrc", rrc_coeffs=co,
                            rrc_steps=steps)


# (sample rate, RxConfig fields, taps per window, taps in shared memory,
# the kernel's shared memory in bytes at QPSK)
GEOMETRIES = {
    "4 Msps": (4e6, {}, 16, True, 6344),
    "2.4 Msps": (2.4e6, {}, 10, True, 6232),
    "rrc_rej 15": (4e6, {"rrc_rej": 15.0}, 8, True, 4232),
    "rrc_steps 2048": (4e6, {"rrc_steps": 2048}, 16, False, 2352),
}

@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_scan_taps_layout(name):
    """The CLI's rrc geometries keep their taps in shared memory (the 16-
    and 10-tap instances) under SMEM_LIMIT; a geometry whose taps do not
    fit beside the input ring selects the device-memory instance, and the
    launch arguments say which."""
    fs, fields, ntaps, shared, nbytes = GEOMETRIES[name]
    p = _rrc_params(fs, **fields)
    assert p.readahead == ntaps
    assert T.taps_in_shared(p, 4) is shared
    assert T.smem_bytes(p, 4) == nbytes <= T.SMEM_LIMIT
    a = T._scan_args(p, 4)
    assert (a.ntaps, a.taps_shared) == (ntaps, int(shared))
    if not shared:
        assert nbytes + len(p.rrc_coeffs) * 8 > T.SMEM_LIMIT


@pytest.mark.parametrize("sampler", ["nearest", "linear"])
def test_scan_no_taps_without_rrc(sampler):
    p = T.ReceiverParams(omega=2.0, sampler=sampler)
    assert not T.taps_in_shared(p, 4)
    assert T._scan_args(p, 4).taps_shared == 0
    assert T.smem_bytes(p, 4) == 2 * (T.CHUNK + p.readahead) * 8 + 3 * 4 * 4


def test_scan_variants_apply_to_the_committed_source():
    """tools/scan_variants.py's variants of csrc/scan_demod.cu: every
    replacement finds its anchor and each variant differs."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import scan_variants
    src = (Path(__file__).resolve().parents[1]
           / "leansdr_tpu_torch/csrc/scan_demod.cu").read_text()
    v = scan_variants.variants(src)
    assert v["committed"] == src and len(v) == 4
    assert "sincos((double)af" in v["trig16 computed in double"]
    assert v["trig16 prefetch"].count("prefetch.global.L1") == 2
    assert "per_sm = 1;" in v["least carveout"]
