"""Carry a `leansdr_tpu` receiver checkpoint into the port.

`from_jax_checkpoint(blob)` turns the pickle written by the JAX
`MultiDvbsReceiver.save_state()` (leansdr_tpu/pipelines/multi_rx.py:
986-1012) into one that `leansdr_tpu_torch.pipelines.multi_rx.
MultiDvbsReceiver.load_state` reads, so the port can continue exactly
where the JAX receiver stopped. The JAX pickle holds only NumPy arrays,
Python scalars and bytes, so loading it needs no JAX.

  * demod state: the Pallas kernel's [19, nsub, 128] planes
    (use_pallas=True) or the scan path's state dict, to [19, C];
  * trellis planes [64, n_lanes] lose their 128-lane padding: C*4 lanes
    in ACQUIRE, C in TRACK;
  * the ring, host policy fields, byte backend blob, sample backlog and
    chunk count carry over as they are.
"""

import pickle

import numpy as np

from .dsp.receiver_kernel import NSTATE
from .pipelines.multi_rx import CHECKPOINT_FORMAT
from .fec.viterbi_device import NSYNCS


def _planes_from_scan_state(st: dict) -> np.ndarray:
    """Scan-path state dict ([C] / [C,3,2] arrays) -> [19, C] planes."""
    hp = np.asarray(st["hist_p"], np.float32)
    hc = np.asarray(st["hist_c"], np.float32)
    rows = [st[k] for k in ("mu", "phase", "freqw", "agc_gain",
                            "est_insp", "est_sp", "est_ep")]
    rows += [hp[:, k, j] for k in range(3) for j in range(2)]
    rows += [hc[:, k, j] for k in range(3) for j in range(2)]
    return np.stack([np.asarray(r, np.float32) for r in rows])


def from_jax_checkpoint(blob: bytes) -> bytes:
    """JAX MultiDvbsReceiver.save_state() pickle -> port checkpoint."""
    d = pickle.loads(blob)
    if d.get("seg_state") is not None:
        raise NotImplementedError(
            "segmented-demod checkpoints are ROADMAP queue 1 item 8")
    dstate = {k: np.asarray(v) for k, v in d["deconv_state"].items()}
    if "path" not in dstate:
        raise NotImplementedError(
            "only rate-1/2 Viterbi fleet checkpoints are ported "
            "(ROADMAP queue 1 items 7 and 9)")
    C = dstate["fill"].shape[0]
    if d["use_pallas"]:
        planes = np.asarray(d["dev"], np.float32).reshape(NSTATE, -1)[:, :C]
    else:
        planes = _planes_from_scan_state(d["dev"])
    host = dict(d["deconv_host"])
    lanes = C if host.get("track") else C * NSYNCS
    for k in ("metric", "path"):
        dstate[k] = np.ascontiguousarray(dstate[k][:, :lanes], np.int32)
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
