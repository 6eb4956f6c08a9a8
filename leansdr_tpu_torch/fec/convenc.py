"""Convolutional encoding for all DVB-S punctured rates (a NumPy copy of
leansdr_tpu/fec/convenc.py: the trellis tables and the TX encoder).

Mirrors convol_multipoly (reference convolutional.h:225-270) and the
shifted-polynomial tables that implement puncturing (reference
dvb.h:520-565): G1=0171, G2=0133, K=7, with per-rate polynomial sets where
the shift amounts encode the puncturing pattern.

The encoder is a GF(2)-linear map from input bits to output bits, so the
vectorized form is XOR-reductions of statically shifted bit lanes — no
per-bit Python or device loop. Streaming state is the last HISTSIZE-1
input bits.
"""

import numpy as np

DVBS_G1 = 0o171
DVBS_G2 = 0o133
HISTSIZE = 16

# Shifted-polynomial sets per code rate (dvb.h:520-550).
POLYS = {
    "1/2": [DVBS_G1, DVBS_G2],
    "2/3": [DVBS_G1, DVBS_G2, DVBS_G2 << 1],
    "4/6": [DVBS_G1, DVBS_G2, DVBS_G2 << 1,
            DVBS_G1 << 2, DVBS_G2 << 2, DVBS_G2 << 3],
    "3/4": [DVBS_G1, DVBS_G2, DVBS_G2 << 1, DVBS_G1 << 2],
    "4/5": [DVBS_G1, DVBS_G2, DVBS_G2 << 1, DVBS_G1 << 2,
            DVBS_G1 << 3],  # non-standard
    "5/6": [DVBS_G1, DVBS_G2, DVBS_G2 << 1, DVBS_G1 << 2,
            DVBS_G2 << 3, DVBS_G1 << 4],
    "7/8": [DVBS_G1, DVBS_G2, DVBS_G2 << 1, DVBS_G2 << 2,
            DVBS_G2 << 3, DVBS_G1 << 4, DVBS_G2 << 5, DVBS_G1 << 6],
}

# {rate: (bits_in, bits_out)} (fec_specs, dvb.h:553-565).
FEC_SPECS = {
    "1/2": (1, 2), "2/3": (2, 3), "4/6": (4, 6), "3/4": (3, 4),
    "5/6": (5, 6), "7/8": (7, 8), "4/5": (4, 5),
}


def encode(data_bytes: np.ndarray, rate: str, bps: int,
           state_bits: np.ndarray | None = None):
    """Encode bytes -> hard symbols, mirroring convol_multipoly.encode.

    The reference shifts each input bit into bit HISTSIZE-1 of a 16-bit
    register shifting right, and after every `bits_in` bits emits
    parity(hist & polys[p]) for each p (convolutional.h:241-259).  After
    absorbing bit index i (0-based), register bit j holds input bit
    i-(HISTSIZE-1-j); poly tap bit j therefore reads the input
    HISTSIZE-1-j steps back.

    Args:
      data_bytes: [n] uint8 input stream (MSB-first bit order).
      rate: code rate name.
      bps: bits per constellation symbol (bits_out %% bps must be 0).
      state_bits: [HISTSIZE-1] previous input bits (oldest first), or None
        for stream start (zeros).
    Returns: (symbols [n*8//bits_in*bits_out//bps] uint8, new state_bits).
    """
    bits_in, bits_out = FEC_SPECS[rate]
    polys = POLYS[rate]
    if bits_out % bps:
        raise ValueError("Code rate not suitable for this constellation")
    bits = np.unpackbits(np.asarray(data_bytes, dtype=np.uint8))
    nbits = len(bits)
    if nbits % bits_in:
        raise ValueError("input not a multiple of bits_in")
    if state_bits is None:
        state_bits = np.zeros(HISTSIZE - 1, dtype=np.uint8)
    ext = np.concatenate([state_bits, bits])          # bit i at ext[15+i-... ]

    # Emission happens after input bit indices i_t = (t+1)*bits_in - 1.
    ngroups = nbits // bits_in
    i_t = (np.arange(ngroups) + 1) * bits_in - 1      # [ngroups]
    out_bits = np.empty((ngroups, bits_out), dtype=np.uint8)
    for p, poly in enumerate(polys):
        taps = [j for j in range(HISTSIZE) if (poly >> j) & 1]
        acc = np.zeros(ngroups, dtype=np.uint8)
        for j in taps:
            # register bit j == input bit i_t - (HISTSIZE-1-j); with the
            # HISTSIZE-1 carried bits prepended that is ext[i_t + j].
            acc ^= ext[i_t + j]
        out_bits[:, p] = acc
    stream = out_bits.reshape(-1)
    symbols = np.packbits(
        stream.reshape(-1, bps), axis=1, bitorder="big"
    )[:, 0] >> (8 - bps)
    new_state = ext[len(ext) - (HISTSIZE - 1):]
    return symbols.astype(np.uint8), new_state
