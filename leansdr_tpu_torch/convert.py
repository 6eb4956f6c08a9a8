"""Carry a `leansdr_tpu` receiver checkpoint into the port.

`from_jax_checkpoint(blob)` turns the pickle written by the JAX
`MultiDvbsReceiver.save_state()` (leansdr_tpu/pipelines/multi_rx.py:
986-1012) into one that `leansdr_tpu_torch.pipelines.multi_rx.
MultiDvbsReceiver.load_state` reads, so the port can continue exactly
where the JAX receiver stopped. The JAX pickle holds only NumPy arrays,
Python scalars and bytes, so loading it needs no JAX.

  * demod state: the Pallas kernel's [19, nsub, 128] planes
    (use_pallas=True) or the scan path's state dict, to [19, C];
  * trellis planes lose their 128-lane padding: C*nsyncs lanes in
    ACQUIRE, C in TRACK (nsyncs = 4 at rate 1/2, 4*nshifts at the
    punctured rates). At a punctured rate the JAX fleet holds them in one
    of two layouts: the TPU banked path's [64, n_lanes] i32 in stored-row
    order, or the CPU XLA-scan path's [C*nsyncs, 64] u32 in natural state
    order (leansdr_tpu/fec/viterbi_device.py:784-789), which is
    transposed, permuted to stored rows and cast to i32;
  * the ring, host policy fields, byte backend blob, sample backlog and
    chunk count carry over as they are.
"""

import pickle

import numpy as np

from .dsp.cstln import Predef, make_dvbs2_constellation
from .dsp.receiver_kernel import NSTATE
from .fec.viterbi import make_sync_maps
from .fec.viterbi_banked import bank_geometry, fleet_rate
from .pipelines.multi_rx import CHECKPOINT_FORMAT


def _planes_from_scan_state(st: dict) -> np.ndarray:
    """Scan-path state dict ([C] / [C,3,2] arrays) -> [19, C] planes."""
    hp = np.asarray(st["hist_p"], np.float32)
    hc = np.asarray(st["hist_c"], np.float32)
    rows = [st[k] for k in ("mu", "phase", "freqw", "agc_gain",
                            "est_insp", "est_sp", "est_ep")]
    rows += [hp[:, k, j] for k in range(3) for j in range(2)]
    rows += [hc[:, k, j] for k in range(3) for j in range(2)]
    return np.stack([np.asarray(r, np.float32) for r in rows])


def _nsyncs(rate: str) -> int:
    """Sync replicas per channel of the QPSK fleet at `rate`."""
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    _, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
    return nconj * nrot * nshifts


def from_jax_checkpoint(blob: bytes, rate: str = "1/2") -> bytes:
    """JAX MultiDvbsReceiver.save_state() pickle -> port checkpoint.

    `rate` is the receiver's code rate (RxConfig.rate): the JAX pickle
    does not record it, and a punctured rate's planes need it."""
    d = pickle.loads(blob)
    if d.get("seg_state") is not None:
        raise NotImplementedError(
            "segmented-demod checkpoints are ROADMAP queue 1 item 8")
    dstate = {k: np.asarray(v) for k, v in d["deconv_state"].items()}
    if "metric" not in dstate:
        raise NotImplementedError(
            "only Viterbi fleet checkpoints are ported (the hard-decision "
            "fleet is ROADMAP queue 1 item 7)")
    rate = fleet_rate(rate)
    if ("path" in dstate) != (rate == "1/2"):
        raise ValueError(f"checkpoint trellis state {sorted(dstate)} is "
                         f"not that of rate {rate}: pass its rate=")
    C = dstate["fill"].shape[0]
    if d["use_pallas"]:
        planes = np.asarray(d["dev"], np.float32).reshape(NSTATE, -1)[:, :C]
    else:
        planes = _planes_from_scan_state(d["dev"])
    host = dict(d["deconv_host"])
    lanes = C if host.get("track") else C * _nsyncs(rate)
    keys = ("metric", "path") if rate == "1/2" else ("metric", "path_hi",
                                                      "path_lo")
    xla = rate != "1/2" and dstate["path_hi"].dtype == np.uint32
    for k in keys:
        v = dstate[k]
        if xla:                        # [S, 64] natural -> [64, S] stored
            v = v.view(np.int32).T[bank_geometry(rate).orig]
        dstate[k] = np.ascontiguousarray(v[:, :lanes], np.int32)
    return pickle.dumps({
        "format": CHECKPOINT_FORMAT,
        "dev": np.ascontiguousarray(planes),
        "deconv_state": dstate,
        "deconv_host": host,
        "backend": d["backend"],
        "backend_native": d["backend_native"],
        "sample_backlog": np.asarray(d["sample_backlog"], np.float32),
        "chunk_count": d.get("chunk_count", 0),
    })
