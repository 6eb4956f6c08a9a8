"""Sample-format conversion between wire formats and float32 IQ planes.

Mirrors cconverter/scaler (reference dsp.h:33-54, leandvb.cc:206-261):
u8 IQ is offset by 128, s16/u16 scaled by 32768, f32 passed through with
an optional --float-scale factor (a copy of leansdr_tpu/util/iofmt.py:
the host-side conversions of file byte streams).
"""

import numpy as np

from . import trace


def read_iq(raw: bytes, fmt: str) -> np.ndarray:
    """Decode raw bytes into [n, 2] float32 IQ, like leandvb's input stage.

    fmt: 'u8' (cu8, offset 128), 's8', 'u16' (offset 32768), 's16',
    'f32' (no scaling here; apply float_scale separately).
    """
    with trace.span("io.read_iq"):
        if fmt == "u8":
            a = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) \
                - 128.0
        elif fmt == "s8":
            a = np.frombuffer(raw, dtype=np.int8).astype(np.float32)
        elif fmt == "u16":
            a = np.frombuffer(raw, dtype=np.uint16).astype(np.float32) \
                - 32768.0
        elif fmt == "s16":
            a = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
        elif fmt == "f32":
            a = np.frombuffer(raw, dtype=np.float32).copy()
        else:
            raise ValueError(fmt)
        return a.reshape(-1, 2)


def write_iq(iq: np.ndarray, fmt: str) -> bytes:
    """Encode [n,2] float32 IQ into wire bytes, like leandvbtx/chansim
    outputs (leandvbtx.cc:171-184, leanchansim.cc:173-184)."""
    flat = np.asarray(iq, dtype=np.float32).reshape(-1)
    if fmt == "f32":
        return flat.tobytes()
    if fmt == "s16":
        # cconverter<f32,0, s16,0, 32768,1>: out = in*32768 truncated
        return np.trunc(flat * 32768.0).astype(np.int16).tobytes()
    if fmt == "u8":
        # cconverter<f32,0, u8,128, 1,1>: out = in + 128 truncated
        return np.trunc(flat + 128.0).astype(np.uint8).tobytes()
    raise ValueError(fmt)
