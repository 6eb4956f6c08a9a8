"""Reed-Solomon RS(204,188) encoder, shortened from RS(255,239) (the
TX-side NumPy parts of leansdr_tpu/fec/rs.py, copied for the stimulus
generator; the receiver's RS decode runs in native/byte_backend.cc).

Mirrors rs_engine (reference rs.h:86-167): GF(256) with P(X)=0x11d and
alpha=2, generator G(X) = prod(X - alpha^i) for i in 0..15.
"""

from functools import lru_cache

import numpy as np

RS_SIZE = 204
MSG_SIZE = 188


@lru_cache(maxsize=None)
def gf_tables():
    """GF(256) log/exp LUTs (rs.h:47-82). exp is doubled to avoid mod 255."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.uint8)
    a = 1
    for i in range(255):
        exp[i] = a
        exp[255 + i] = a
        log[a] = i
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
    exp[510] = exp[0]
    exp[511] = exp[1]
    return exp, log


def gf_mul(x, y):
    exp, log = gf_tables()
    x = np.asarray(x, dtype=np.uint8)
    y = np.asarray(y, dtype=np.uint8)
    out = exp[log[x].astype(np.int32) + log[y].astype(np.int32)]
    return np.where((x == 0) | (y == 0), 0, out).astype(np.uint8)


@lru_cache(maxsize=None)
def generator_poly() -> np.ndarray:
    """G as [G_16..G_0] with G_16=1 (rs.h:93-102)."""
    exp, _ = gf_tables()
    G = np.zeros(17, dtype=np.uint8)
    G[16] = 1
    for d in range(16):
        shifted = np.concatenate([G[1:], [0]])       # X*G
        G = shifted ^ gf_mul(exp[d], G)              # X*G - alpha^d*G
    return G


def encode(msgs: np.ndarray) -> np.ndarray:
    """Append 16 parity bytes to [n,188] messages -> [n,204] (rs.h:141-167)."""
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    n = msgs.shape[0]
    G = generator_poly()
    p = np.zeros((n, RS_SIZE), dtype=np.uint8)
    p[:, :MSG_SIZE] = msgs
    for d in range(MSG_SIZE):
        k = p[:, d].copy()         # G[0] == 1, so div(p[d], G[0]) == p[d]
        p[:, d:d + 17] ^= gf_mul(k[:, None], G[None, :])
    out = np.concatenate([msgs, p[:, MSG_SIZE:]], axis=1)
    return out
