"""DVB-S energy-dispersal PRBS (de)randomizer (a copy of
leansdr_tpu/fec/prbs.py: the TX randomizer of the stimulus generator,
the single-carrier receiver's derandomizer, and `derandomize_scan` on
tensors; the fleet's derandomizer runs in native/byte_backend.cc).

Mirrors randomizer/derandomizer (reference dvb.h:1063-1163): the
EN 300 421 section 4.4.1 PRBS 1+x^14+x^15 seeded 000251, precomputed as
a 188*8-byte pattern with the sync-byte inversion/inhibition rules.
"""

from functools import lru_cache

import numpy as np
import torch

MPEG_SYNC = 0x47
MPEG_SYNC_INV = MPEG_SYNC ^ 0xFF           # 0xB8
MPEG_SYNC_CORRUPTED = 0x55


@lru_cache(maxsize=None)
def prbs_pattern() -> np.ndarray:
    """The 188*8-byte pattern (dvb.h:1072-1085).

    pattern[0] = 0xff (sync inversion); PRBS bytes elsewhere, zeroed on the
    7 other sync-byte positions (inhibited but still clocked).
    """
    pat = np.zeros(188 * 8, dtype=np.uint8)
    pat[0] = 0xFF
    st = 0o000251
    for i in range(1, 188 * 8):
        out = 0
        for _ in range(8):
            bit = ((st >> 13) ^ (st >> 14)) & 1
            out = ((out << 1) | bit) & 0xFF
            st = ((st << 1) | bit) & 0xFFFF
        pat[i] = out if (i % 188) else 0
    return pat


def randomize(packets: np.ndarray, start_phase: int = 0):
    """TX randomizer over a [n, 188] u8 array starting at 8-packet phase
    `start_phase`. Returns (out, next_phase)."""
    n = packets.shape[0]
    pat = prbs_pattern().reshape(8, 188)
    phases = (start_phase + np.arange(n)) % 8
    out = packets ^ pat[phases]
    return out, int((start_phase + n) % 8)


def derandomize_scan(packets: torch.Tensor, pos0):
    """RX derandomizer (dvb.h:1130-1157) over [n, 188] uint8 packets on
    their device, the counterpart of JAX's lax.scan version.

    The pattern position (0..7, in packets) is carried across the
    stream and resynchronizes to 0 at a sync byte of MPEG_SYNC_INV or
    its corrupted marker; vectorized: packet i uses (i - last resync at
    or before i) % 8, or (pos0 + i) % 8 before the first resync. Returns
    (out [n, 188], good mask [n], next pos as a 0-d int32 tensor). The
    caller drops packets whose descrambled sync != 0x47 and sets the TEI
    bit, as the reference does."""
    dev = packets.device
    n = packets.shape[0]
    pat = torch.from_numpy(prbs_pattern().reshape(8, 188)).to(dev)
    i = torch.arange(n, device=dev)
    sync = packets[:, 0]
    resync = (sync == MPEG_SYNC_INV) | (
        sync == (MPEG_SYNC_INV ^ MPEG_SYNC_CORRUPTED))
    last = torch.where(resync, i, torch.full_like(i, -1))
    if n:
        last = torch.cummax(last, dim=0).values
    pos0 = torch.as_tensor(pos0, device=dev).to(torch.int64)
    pos = torch.where(last >= 0, i - last, pos0 + i) % 8
    out = packets ^ pat[pos]
    good = out[:, 0] == MPEG_SYNC
    next_pos = ((pos[-1] + 1) % 8) if n else pos0 % 8
    return out, good, next_pos.to(torch.int32)


def derandomize_np(packets: np.ndarray, pos: int = 0):
    """Vectorized host derandomizer (dvb.h:1130-1157).

    Returns (out_packets [n,188], good_mask [n], next_pos). Bad packets
    get the TEI bit set, mirroring dvb.h:1146-1156; the caller drops them
    via the mask.

    The sequential position recurrence (reset to 0 on inverted sync,
    else +1 mod 8) vectorizes as distance-to-last-resync: pos[i] =
    (i - last_resync_at_or_before_i) %% 8, falling back to the carried-in
    phase before the first resync.
    """
    packets = np.atleast_2d(packets)
    n = packets.shape[0]
    if n == 0:
        return packets.copy(), np.zeros(0, bool), pos
    pat = prbs_pattern().reshape(8, 188)
    sync_in = packets[:, 0]
    resync = (sync_in == MPEG_SYNC_INV) | (
        sync_in == (MPEG_SYNC_INV ^ MPEG_SYNC_CORRUPTED))
    idx = np.arange(n)
    last = np.maximum.accumulate(np.where(resync, idx, -1))
    positions = np.where(last >= 0, (idx - last) % 8, (pos + idx) % 8)
    out = packets ^ pat[positions]
    good = out[:, 0] == MPEG_SYNC
    out[~good, 1] |= 0x80  # Transport Error Indicator
    next_pos = int((positions[-1] + 1) % 8)
    return out, good, next_pos
