"""Carry a `leansdr_tpu` receiver checkpoint into the port.

`from_jax_dvbs_checkpoint(blob)` does it for the single-carrier
`DvbsReceiver` (see its docstring); `from_jax_checkpoint(blob)` for the
fleet. It turns the pickle written by the JAX
`MultiDvbsReceiver.save_state()` (leansdr_tpu/pipelines/multi_rx.py:
986-1012) into one that `leansdr_tpu_torch.pipelines.multi_rx.
MultiDvbsReceiver.load_state` reads, so the port can continue exactly
where the JAX receiver stopped. The JAX pickle holds only NumPy arrays,
Python scalars and bytes, so loading it needs no JAX.

  * demod state: the Pallas kernel's [19, nsub, 128] planes
    (use_pallas=True) to [19, C], or the scan path's state dict (the rrc
    sampler's `rrc_phase` and `rrc_shifted` included) as it is; the
    segmented demod's per-segment states (`seg_state`, `segments=S`)
    likewise, [19, S*C] or a dict of S*C lanes, with `seg_nseg`. The
    port's load_state converts either form to its own route's (planes
    for the demod kernel, the dict for the scan demod);
  * Viterbi fleets: trellis planes lose their 128-lane padding:
    C*nsyncs lanes in ACQUIRE, C in TRACK (nsyncs = nmaps * nshifts of
    the receiver's constellation and rate: 4 for QPSK 1/2, up to 32).
    On the banked route (every (constellation, rate) but QPSK-class 1/2,
    so BPSK 1/2 too) the JAX fleet holds them in one of two layouts: the
    TPU banked path's [64, n_lanes] i32 in stored-row order, or the CPU
    XLA-scan path's [C*nsyncs, 64] u32 in natural state order
    (leansdr_tpu/fec/viterbi_device.py:784-789), which is transposed,
    permuted to stored rows and cast to i32;
  * hard-decision fleets (viterbi=False, the JAX DeviceDeconvolver):
    the ring `buf`, `fill` and `locked` hypotheses and the host fill
    estimate `_est_fill` carry over as they are;
  * the ring, host policy fields, byte backend blob (the C++ backend's,
    or the Python `_ByteBackend`'s pickle, backend_native
    "_ByteBackend"), sample backlog and chunk count carry over as they
    are.
"""

import io
import pickle

import numpy as np

from .dsp.cstln import Predef, make_dvbs2_constellation
from .dsp.receiver_kernel import NSTATE
from .fec.viterbi import make_sync_maps
from .fec.viterbi_banked import bank_geometry, fleet_rate
from .fec.viterbi_device import NSYNCS
from .pipelines.multi_rx import CHECKPOINT_FORMAT


def _dem_state(use_pallas: bool, st, lanes):
    """A JAX demod state: Pallas [19, nsub, 128] lane tiles -> [19, lanes]
    float32, or the scan path's dict as NumPy arrays. lanes=None keeps
    every lane up to the last one in use: the tiles' padding lanes are
    all zero, a live lane never is (its AGC gain is positive)."""
    if not use_pallas:
        return {k: np.asarray(v) for k, v in st.items()}
    flat = np.asarray(st, np.float32).reshape(NSTATE, -1)
    if lanes is None:
        lanes = int(np.flatnonzero(np.abs(flat).sum(axis=0))[-1]) + 1
    return np.ascontiguousarray(flat[:, :lanes])


def _syncs(rate: str, constellation) -> tuple:
    """(sync replicas per channel, banked route) of the fleet's Viterbi
    at trellis rate `rate` on `constellation`, as MultiViterbiSync
    routes them."""
    cstln = make_dvbs2_constellation(constellation, rate)
    _, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
    return (nconj * nrot * nshifts,
            not (nconj * nrot == NSYNCS and nshifts == 1))


def _trellis_planes(dstate: dict, host: dict, rate: str,
                    constellation) -> None:
    """A JAX Viterbi fleet's trellis planes, in place, to the port's
    [64, lanes] i32 stored-row layout without lane padding."""
    rate = fleet_rate(rate)
    nsyncs, banked = _syncs(rate, constellation)
    if ("path" in dstate) == banked:
        raise ValueError(f"checkpoint trellis state {sorted(dstate)} is "
                         f"not that of rate {rate} on {constellation.name}:"
                         " pass its rate= and constellation=")
    C = dstate["fill"].shape[0]
    lanes = C if host.get("track") else C * nsyncs
    keys = ("metric", "path_hi", "path_lo") if banked else ("metric", "path")
    xla = banked and dstate["path_hi"].dtype == np.uint32
    for k in keys:
        v = dstate[k]
        if xla:                        # [S, 64] natural -> [64, S] stored
            v = v.view(np.int32).T[bank_geometry(rate).orig]
        dstate[k] = np.ascontiguousarray(v[:, :lanes], np.int32)


def from_jax_checkpoint(blob: bytes, rate: str = "1/2",
                        constellation=Predef.QPSK) -> bytes:
    """JAX MultiDvbsReceiver.save_state() pickle -> port checkpoint, of
    a Viterbi fleet or of a hard-decision one (viterbi=False).

    `rate` and `constellation` are the receiver's (RxConfig.rate and
    .constellation): the JAX pickle records neither, and the trellis
    planes' lane count and layout need them (a hard-decision fleet's
    state depends on neither). The JAX fleet keeps no preprocessing
    state (notch, CNR, spectrum) in its pickle, and neither does the
    port's."""
    d = pickle.loads(blob)
    dstate = {k: np.asarray(v) for k, v in d["deconv_state"].items()}
    host = dict(d["deconv_host"])
    if "metric" in dstate:
        _trellis_planes(dstate, host, rate, Predef(constellation))
    elif set(dstate) != {"buf", "fill", "locked"}:
        raise ValueError(f"checkpoint decoder state {sorted(dstate)} is "
                         "neither a Viterbi nor a hard-decision fleet's")
    C = dstate["fill"].shape[0]
    dem = _dem_state(d["use_pallas"], d["dev"], C)
    seg = d.get("seg_state")
    if seg is not None:
        seg = _dem_state(d["use_pallas"], seg, None)
        lanes = seg["mu"].shape[0] if isinstance(seg, dict) else seg.shape[1]
        if lanes % C:
            raise ValueError(f"checkpoint segment states: {lanes} lanes "
                             f"for {C} channels")
    return pickle.dumps({
        "format": CHECKPOINT_FORMAT,
        "use_pallas": d["use_pallas"],
        "dev": dem,
        "seg_state": seg,
        "seg_nseg": d.get("seg_nseg", 0),
        "deconv_state": dstate,
        "deconv_host": host,
        "backend": d["backend"],
        "backend_native": d["backend_native"],
        "sample_backlog": np.asarray(d["sample_backlog"], np.float32),
        "chunk_count": d.get("chunk_count", 0),
    })


# ---------------------------------------------------------------------------
# Single-carrier receiver
# ---------------------------------------------------------------------------

def _np_array(fun, args, arr_state, aval_state):
    """Stand-in for jax._src.array._reconstruct_array: the NumPy value a
    pickled JAX array carries, without placing it on a JAX device."""
    v = fun(*args)
    v.__setstate__(arr_state)
    return v


class _Unread:
    """Stand-in for a pickled object whose fields the conversion does not
    read (the JAX decoder's host ACS bank: the device path keeps its
    trellis state in `_dev_state`)."""


def _stand_ins() -> dict:
    from .dsp import blocks_device
    from .fec import deconv, viterbi
    from .proto import hdlc
    return {
        ("jax._src.array", "_reconstruct_array"): _np_array,
        ("leansdr_tpu.fec.deconv", "DeconvSpec"): deconv.DeconvSpec,
        ("leansdr_tpu.fec.viterbi", "Trellis"): viterbi.Trellis,
        ("leansdr_tpu.fec.viterbi", "ViterbiBank"): _Unread,
        ("leansdr_tpu.dsp.blocks_device", "BatchedAutoNotch"):
            blocks_device.BatchedAutoNotch,
        ("leansdr_tpu.dsp.blocks_device", "_Backlog"):
            blocks_device._Backlog,
        ("leansdr_tpu.dsp.blocks_device", "BatchedCnrFft"):
            blocks_device.BatchedCnrFft,
        ("leansdr_tpu.dsp.blocks_device", "BatchedSpectrum"):
            blocks_device.BatchedSpectrum,
        ("leansdr_tpu.proto.hdlc", "HdlcDec"): hdlc.HdlcDec,
    }


class _JaxFreeUnpickler(pickle.Unpickler):
    """Reads a leansdr_tpu pickle without importing jax or leansdr_tpu:
    the classes it names are mapped to the port's own (same fields) or to
    NumPy; anything else from those packages raises, naming it."""

    def find_class(self, module, name):
        hit = _stand_ins().get((module, name))
        if hit is not None:
            return hit
        if module.split(".")[0] in ("jax", "jaxlib", "leansdr_tpu"):
            raise NotImplementedError(
                f"{module}.{name} in the checkpoint has no stand-in in "
                "leansdr_tpu_torch.convert")
        return super().find_class(module, name)


def _notch_state(st) -> dict:
    """The notch's streaming state: from the host blocks.AutoNotch fields
    (a JAX checkpoint written on the CPU) or from AutoNotch1's
    BatchedAutoNotch (written on an accelerator)."""
    if "b" in st:
        b = st["b"].__dict__
        return {"slot_i": b["slot_i"], "estim": b["estim"],
                "gain": b["gain"], "phase": b["phase"],
                "backlog": b["backlog"].buf}
    est = np.asarray(st["estim"], np.complex64)
    return {"slot_i": np.asarray(st["slot_i"], np.int32)[None],
            "estim": np.stack([est.real, est.imag], -1)[None].astype(
                np.float32),
            "gain": np.array([st["gain"]], np.float32),
            "phase": int(st["phase"]),
            "backlog": np.stack([st["backlog"].real, st["backlog"].imag],
                                -1)[None].astype(np.float32)}


def _estimator_state(st) -> dict:
    """--cnr's or --fd-spectrum's streaming state (EMA'd power, block
    phase, sample backlog): from the host blocks.CnrFft / blocks.Spectrum
    fields (a JAX checkpoint written on the CPU) or from CnrFft1's /
    Spectrum1's batched block (written on an accelerator)."""
    if "b" in st:
        b = st["b"].__dict__
        return {"avgpower": b["avgpower"], "phase": int(b["phase"]),
                "backlog": b["backlog"].buf}
    avg = st["avgpower"]
    bl = np.asarray(st["backlog"], np.complex64)
    return {"avgpower": (None if avg is None else
                         np.asarray(avg, np.float32)[None]),
            "phase": int(st["phase"]),
            "backlog": np.stack([bl.real, bl.imag], -1)[None].astype(
                np.float32)}


def _viterbi_state(dc: dict, rate: str) -> dict:
    """ViterbiSyncDevice fields; the trellis state _dev_state
    (cost_st [S, 64] i32, path_hi/path_lo [S, 64] u32, natural state
    order, S = the decoder's nsyncs at any constellation) to the port's
    planes: [64, S] i32; at rate 1/2 (metric, path = path_lo), the low
    path word being all that reaches the decision at depth 32; at the
    other rates (2/3 and 4/5 too) permuted to stored rows."""
    out = {k: dc[k] for k in ("current", "resync_phase", "sym_backlog",
                              "cost_backlog")}
    dev = dc.get("_dev_state")
    if dev is None:
        out["planes"] = None
        return out
    cst, hi, lo = (np.asarray(a) for a in dev)
    if rate == "1/2":
        out["planes"] = {"metric": cst.T, "path": lo.view(np.int32).T}
    else:
        orig = bank_geometry(rate).orig
        out["planes"] = {k: np.ascontiguousarray(
            np.asarray(a).view(np.int32).T[orig])
            for k, a in (("metric", cst), ("path_hi", hi), ("path_lo", lo))}
    return out


def from_jax_dvbs_checkpoint(blob: bytes) -> bytes:
    """JAX DvbsReceiver.save_state() pickle -> a checkpoint the port's
    `pipelines.dvbs_rx.DvbsReceiver.load_state` reads, at any
    constellation and code rate.

    The JAX pickle names classes (the deconvolver's DeconvSpec, the
    Viterbi decoder's Trellis and host ViterbiBank, JAX arrays in its trellis
    state, the notch's BatchedAutoNotch when written on an accelerator);
    it is read with an unpickler that maps them to the port's classes or
    to NumPy, so neither jax nor leansdr_tpu is imported. Carried over:
    the demod state (kernel planes to [19, 1], or the scan path's dict),
    the --hs receiver's state, the sample, byte and MPEG backlogs, the
    derandomizer phase, the --awgn noise stream's draw count, the
    decoder's streaming state (the --hs deconvolver's too), the MPEG
    sync FSM, counters, measurements (the CNR values too), the notch /
    derotator / CNR estimator / spectrum / resampler streaming state,
    and with --hdlc the ETR192 descrambler state and the HDLC sync's
    fields (its two HdlcDec deframers as the port's). The measurement
    phase is not in the JAX pickle and starts at 0, as in a JAX receiver
    that loads it."""
    from .pipelines.dvbs_rx import CHECKPOINT_FORMAT as DVBS_FORMAT
    d = _JaxFreeUnpickler(io.BytesIO(blob)).load()
    aux = d.get("aux", {})
    dem = _dem_state(d["use_pallas"], d["dev"], 1)
    dc = d["deconv"]
    if "trellis" in dc:
        deconv = _viterbi_state(dc, dc["rate"])
    elif "resync_period" in dc:              # the --hs deconvolver
        deconv = {k: dc[k] for k in ("locked", "resync_phase", "backlog")}
    else:
        deconv = {k: dc[k] for k in ("locked", "skip", "backlog")}
    out_aux = {}
    if "etr_state" in aux:
        out_aux["etr_state"] = tuple(int(v) for v in aux["etr_state"])
        out_aux["hdlc_sync"] = dict(aux["hdlc_sync"])
    if "hs_state" in aux:
        out_aux["hs_state"] = {k: np.asarray(v)
                               for k, v in aux["hs_state"].items()}
    if "notch" in aux:
        out_aux["notch"] = _notch_state(aux["notch"])
    if "derot" in aux:
        out_aux["derot"] = {"index": int(aux["derot"]["index"])}
    for name in ("cnr_est", "spectrum"):
        if name in aux:
            out_aux[name] = _estimator_state(aux[name])
    if "resampler" in aux:
        r = aux["resampler"]
        out_aux["resampler"] = {"current_freq": float(r["current_freq"]),
                                "hist": np.asarray(r["hist"], np.complex64),
                                "_primed": bool(r["_primed"])}
    return pickle.dumps({
        "format": DVBS_FORMAT,
        "use_pallas": d["use_pallas"],
        "dev": dem,
        "meas_backlog": 0,
        "sample_backlog": np.asarray(d["sample_backlog"], np.float32),
        "byte_backlog": d["byte_backlog"],
        "mpegbyte_backlog": d["mpegbyte_backlog"],
        "derand_pos": d["derand_pos"],
        "first_derand": d["first_derand"],
        "noise_draws": d.get("noise_draws", 0),
        "deconv": deconv,
        "mpeg": d["mpeg"],
        "vbitcount": d["vbitcount"],
        "verrcount": d["verrcount"],
        "meas": d["meas"],
        "aux": out_aux,
    })
