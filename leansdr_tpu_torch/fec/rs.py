"""Reed-Solomon RS(204,188), shortened from RS(255,239): the NumPy parts
of leansdr_tpu/fec/rs.py (TX encoder; the single-carrier receiver's
syndromes, Berlekamp-Massey, Forney correction and decode).

Mirrors rs_engine (reference rs.h:86-272): GF(256) with P(X)=0x11d and
alpha=2, generator G(X) = prod(X - alpha^i) for i in 0..15, syndromes by
Horner evaluation (or, for large batches, as one GF(2)-linear float32
matmul), Berlekamp-Massey + Forney with exhaustive root search, up to 8
byte errors corrected per packet. (The fleet's RS decode runs in
native/byte_backend.cc.) `gf2_encode_matrix` and `gf2_syndrome_matrix`
are the encoder and the syndromes as GF(2) matrices; `torch_encode` and
`torch_syndromes` (the counterparts of jax_encode / jax_syndromes) apply
them on the tensor's device as one float32 matmul of 0/1 planes, mod 2
(the device modulator's RS encode).
"""

from functools import lru_cache

import numpy as np
import torch

from .. import device as _dev

N_PARITY = 16
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


def gf_div(x, y):
    exp, log = gf_tables()
    x = np.asarray(x, dtype=np.uint8)
    y = np.asarray(y, dtype=np.uint8)
    out = exp[log[x].astype(np.int32) + 255 - log[y].astype(np.int32)]
    return np.where(x == 0, 0, out).astype(np.uint8)


def gf_inv(x):
    exp, log = gf_tables()
    return exp[255 - log[np.asarray(x, dtype=np.uint8)].astype(np.int32)]


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


@lru_cache(maxsize=None)
def _syndrome_consts() -> np.ndarray:
    """consts[j, i] = alpha^(i*(203-j)): synd_i = XOR_j mul(poly[j], consts)."""
    exp, _ = gf_tables()
    j = np.arange(RS_SIZE)
    i = np.arange(N_PARITY)
    powers = (i[None, :] * (RS_SIZE - 1 - j[:, None])) % 255
    return exp[powers]


def syndromes(packets: np.ndarray) -> np.ndarray:
    """[n,204] -> [n,16] syndromes synd[i] = P(alpha^i) (rs.h:116-129).

    Large batches use the GF(2)-linear formulation as one float32 BLAS
    matmul (exact: bit-count sums < 2^24), ~10x faster than the per-byte
    table XOR reduction for batches of that size."""
    packets = np.atleast_2d(np.asarray(packets, dtype=np.uint8))
    if packets.shape[0] >= 64:
        bits = np.unpackbits(packets, axis=1).astype(np.float32)
        M = _gf2_syndrome_matrix_f32()                   # [1632, 128]
        sbits = (bits @ M).astype(np.int32) & 1
        return np.packbits(sbits.astype(np.uint8), axis=1)
    c = _syndrome_consts()                   # [204,16]
    prod = gf_mul(packets[:, :, None], c[None, :, :])
    return np.bitwise_xor.reduce(prod, axis=1)


def _eval_all_points(coeffs: np.ndarray, maxdeg: np.ndarray) -> np.ndarray:
    """Evaluate polynomials [n,16] (coeffs by increasing degree, degree
    limited per-row by maxdeg) at all 255 points alpha^j -> [n,255].

    Horner over the 16 coefficients on [n,255] planes: 16 small
    gather-XOR steps instead of one [n,16,255] materialization (the
    latter allocated ~100MB per thousand packets and dominated decode
    time on corrupted batches)."""
    exp, log = gf_tables()
    n = coeffs.shape[0]
    i = np.arange(16)
    cm = np.where(i[None, :] <= maxdeg[:, None], coeffs, 0)   # [n,16]
    logx = np.arange(255, dtype=np.int32)                     # log alpha^j
    val = np.broadcast_to(cm[:, 15:16], (n, 255)).copy()
    for d in range(14, -1, -1):
        nz = val != 0
        val = np.where(nz, exp[log[val].astype(np.int32) + logx[None, :]],
                       0)
        val ^= cm[:, d:d + 1]
    return val


def berlekamp_massey(synd: np.ndarray):
    """Batched BM (rs.h:177-201): returns (C [n,16], L [n])."""
    synd = np.atleast_2d(synd)
    n = synd.shape[0]
    C = np.zeros((n, 16), dtype=np.uint8)
    B = np.zeros((n, 16), dtype=np.uint8)
    C[:, 0] = 1
    B[:, 0] = 1
    L = np.zeros(n, dtype=np.int32)
    m = np.ones(n, dtype=np.int32)
    b = np.ones(n, dtype=np.uint8)
    idx = np.arange(16)
    for step in range(16):
        # discrepancy d = synd[step] + sum_{i=1..L} C[i]*synd[step-i]
        d = synd[:, step].copy()
        for i in range(1, 16):
            active = (i <= L) & (step - i >= 0)
            term = gf_mul(C[:, i], synd[:, max(step - i, 0)])
            d ^= np.where(active, term, 0)
        upd = d != 0
        grow = upd & (2 * L <= step)
        # shifted update: C[m+i] ^= d/b * B[i]
        scale = gf_mul(d, gf_inv(b))
        # build shifted B per row: shifted[:, m+i] = B[:, i]
        shiftedB = np.zeros_like(B)
        for mm in range(1, 17):
            rows = m == mm
            if not rows.any():
                continue
            if mm < 16:
                shiftedB[rows, mm:] = B[rows, : 16 - mm]
        delta = gf_mul(scale[:, None], shiftedB)
        T = C.copy()
        C = np.where(upd[:, None], C ^ delta, C)
        B = np.where(grow[:, None], T, B)
        b = np.where(grow, d, b)
        L = np.where(grow, step + 1 - L, L)
        m = np.where(grow, 1, m + 1)
    return C, L


def correct(packets: np.ndarray, synd: np.ndarray):
    """Batched Forney correction (rs.h:213-269).

    Returns (corrected [n,204], still_corrupted [n] bool, bits_corrected [n]).
    """
    exp, log = gf_tables()
    packets = np.atleast_2d(np.asarray(packets, dtype=np.uint8))
    synd = np.atleast_2d(synd)
    n = packets.shape[0]

    C, L = berlekamp_massey(synd)

    # Omega = (synd * C) mod X^16
    omega = np.zeros((n, 16), dtype=np.uint8)
    for i in range(16):
        for j in range(16 - i):
            omega[:, i + j] ^= gf_mul(synd[:, i], C[:, j])

    # Lambda' (formal derivative, even-index coefficients of C shifted)
    Cprime = np.zeros((n, 16), dtype=np.uint8)
    for i in range(15):
        if i % 2 == 0:
            Cprime[:, i] = C[:, i + 1]

    # Evaluate C at all alpha^j; roots where value == 0 and C nonzero.
    Cv = _eval_all_points(C, L)                        # [n,255]
    Ov = _eval_all_points(omega, L)
    Dv = _eval_all_points(Cprime, np.full(n, 14))

    jj = np.arange(255)
    loc = (255 - jj) % 255                             # byte position (log xk)
    valid = (Cv == 0) & (loc < RS_SIZE)[None, :] & (L > 0)[:, None]
    xk = exp[loc]                                       # inverse of root
    e = gf_div(gf_mul(np.broadcast_to(xk, (n, 255)), Ov), np.where(Dv == 0, 1, Dv))
    e = np.where(valid & (Dv != 0), e, 0)

    E = np.zeros((n, RS_SIZE), dtype=np.uint8)
    cols = RS_SIZE - 1 - loc                            # 203-loc
    sel = loc < RS_SIZE
    E[:, cols[sel]] ^= e[:, sel]

    corrected = packets ^ E
    bits = np.unpackbits(E, axis=1).sum(axis=1).astype(np.int32)
    still = syndromes(corrected).any(axis=1)
    return corrected, still, bits


def decode(packets: np.ndarray):
    """Full RS decode of [n,204] packets.

    Returns (msgs [n,188], failed [n] bool, bits_corrected [n]).
    Failed packets keep their (possibly wrong) message bytes; the caller
    marks them (sync ^ 0x55) like rs_decoder (dvb.h:1043-1046).
    """
    packets = np.atleast_2d(np.asarray(packets, dtype=np.uint8))
    synd = syndromes(packets)
    corrupted = synd.any(axis=1)
    out = packets.copy()
    failed = np.zeros(packets.shape[0], dtype=bool)
    bits = np.zeros(packets.shape[0], dtype=np.int32)
    if corrupted.any():
        sub = np.where(corrupted)[0]
        fixed, still, b = correct(packets[sub], synd[sub])
        out[sub] = fixed
        failed[sub] = still
        bits[sub] = b
    return out[:, :MSG_SIZE], failed, bits


@lru_cache(maxsize=None)
def _gf2_syndrome_matrix_f32() -> np.ndarray:
    """float32 copy of gf2_syndrome_matrix for the host BLAS path (the
    conversion is not free at per-chunk cadence)."""
    return gf2_syndrome_matrix().astype(np.float32)


@lru_cache(maxsize=None)
def gf2_syndrome_matrix() -> np.ndarray:
    """[204*8, 16*8] GF(2) matrix: syndrome bits = packet bits @ M (mod 2)."""
    c = _syndrome_consts()                  # [204,16] multipliers
    rows = []
    for byte in range(RS_SIZE):
        for bit in range(8):
            v = np.uint8(1 << (7 - bit))
            s = gf_mul(v, c[byte])          # [16]
            rows.append(np.unpackbits(s))
    return np.array(rows, dtype=np.int8)


@lru_cache(maxsize=None)
def gf2_encode_matrix() -> np.ndarray:
    """[188*8, 16*8] GF(2) matrix: parity bits = msg bits @ M (mod 2), the
    device modulator's RS encode (the matrix of leansdr_tpu/fec/rs.py:
    258-268). Row byte*8 + bit is the parity of the message with that one
    bit set; the 1504 messages go through `encode` as one batch."""
    msgs = np.zeros((MSG_SIZE * 8, MSG_SIZE), dtype=np.uint8)
    k = np.arange(MSG_SIZE * 8)
    msgs[k, k // 8] = (1 << (7 - k % 8)).astype(np.uint8)
    parity = encode(msgs)[:, MSG_SIZE:]
    return np.unpackbits(parity, axis=1).astype(np.int8)


@lru_cache(maxsize=None)
def _gf2_matrix_f32(kind: str, device: torch.device) -> torch.Tensor:
    m = gf2_encode_matrix() if kind == "encode" else gf2_syndrome_matrix()
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _gf2_product(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """bits [n, k] (0/1, any dtype) @ the GF(2) matrix, mod 2, as uint8.
    Each sum counts at most k <= 1632 ones, exact in float32 with TF32
    off."""
    m = _gf2_matrix_f32(kind, bits.device)
    with _dev.fp32_matmul():
        acc = torch.matmul(bits.to(torch.float32), m)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def torch_encode(msgs_bits: torch.Tensor) -> torch.Tensor:
    """[n, 1504] message bits -> [n, 128] parity bits (uint8)."""
    return _gf2_product(msgs_bits, "encode")


def torch_syndromes(packet_bits: torch.Tensor) -> torch.Tensor:
    """[n, 1632] packet bits -> [n, 128] syndrome bits (uint8)."""
    return _gf2_product(packet_bits, "syndrome")
