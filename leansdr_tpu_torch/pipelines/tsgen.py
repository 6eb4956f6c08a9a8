"""Numbered MPEG-TS packet generator (reference leantsgen.cc:36-48; a
copy of leansdr_tpu/pipelines/tsgen.py).

Each 188-byte packet: repeating 4-byte groups of {byte offset, 24-bit
packet number big-endian}, with byte 0 forced to the 0x47 sync. SIZE=188
means the last group of 4 starts at 184 (i+3<188).
"""

import numpy as np

TS_SIZE = 188


def generate(count: int, start: int = 0) -> np.ndarray:
    """Generate [count, 188] numbered TS packets starting at `start`."""
    t = (np.arange(start, start + count, dtype=np.int64))[:, None]
    pkt = np.zeros((count, TS_SIZE), dtype=np.uint8)
    i = np.arange(0, TS_SIZE - 3, 4)
    pkt[:, i] = i.astype(np.uint8)[None, :]
    pkt[:, i + 1] = ((t >> 16) & 0xFF).astype(np.uint8)
    pkt[:, i + 2] = ((t >> 8) & 0xFF).astype(np.uint8)
    pkt[:, i + 3] = (t & 0xFF).astype(np.uint8)
    pkt[:, 0] = 0x47
    return pkt
