"""What decides `correct`, apart from the soft layers' reference
(reference.py): the TS packets against the packets sent, and the
decoder's bytes against the interleaved stream sent.

Every function here reads the program's outputs and the benchmark's own
capture; none imports the program.
"""

import numpy as np

from .stimulus import RS_SIZE, TS_SIZE, Capture


def packet_numbers(pkts: np.ndarray) -> np.ndarray:
    """The 24-bit numbers in bytes 1..3 of [n, 188] packets."""
    p = pkts.astype(np.int64)
    return (p[:, 1] << 16) | (p[:, 2] << 8) | p[:, 3]


class PacketLedger:
    """Every TS packet a run gave back, per carrier, with the time of the
    call that returned it; after the run, each is matched to the packet
    sent and dated by the hand-over of the input that completed it.

    A carrier's packets are read in order. Each must be a packet sent on
    that carrier (number and all 188 bytes), and each must follow the one
    before it: a packet whose number is k places after the last (around
    the loop) stands for k - 1 packets lost; one with the same number as
    the last is a repeat and counts as bad."""

    def __init__(self, cap: Capture, nchan: int):
        self.cap = cap
        self.nchan = nchan
        self.calls = []             # (t_return, [[k, 188] per carrier])

    def add(self, t_return: float, per_carrier) -> None:
        self.calls.append((t_return, per_carrier))

    def settle(self, handovers: np.ndarray, chunk: int, first: int,
               due_samples: int):
        """Match and date every packet. handovers[j] is the hand-over
        time of input j (samples [j * chunk, (j + 1) * chunk) of the
        stream). A packet is due when its last sample lies in [first,
        due_samples): the packets added are the window's, `first` its
        first sample plus the decoder's delay, `due_samples` its last
        less that delay. Returns the totals and, over the packets matched,
        their return times `t`, the input `chunk` that completed each and
        its latency."""
        N, L = self.cap.npkt, self.cap.period
        sent = self.cap.packets
        out = dict(bad=0, lost=0, undelivered=0, t=[], latency=[], chunk=[])
        ends = self.cap.end_sample

        def count_due(lo, hi):
            """Packets whose end sample lies in [lo, hi)."""
            def upto(s):            # packets with end < s
                return int(s // L * N + (ends < s % L).sum()) if s > 0 else 0
            return max(0, upto(hi) - upto(lo))

        for c in range(self.nchan):
            parts = [(t, pc[c]) for t, pc in self.calls if len(pc[c])]
            if not parts:
                out["undelivered"] += count_due(first, due_samples)
                continue
            pk = np.concatenate([p for _, p in parts])
            tr = np.concatenate([np.full(len(p), t) for t, p in parts])
            k = packet_numbers(pk) - c * N
            inrange = (k >= 0) & (k < N)
            kk = np.where(inrange, k, 0)
            good = inrange & (pk == sent[c, kk]).all(axis=1)
            out["bad"] += int((~good).sum())
            kg, tg = kk[good], tr[good]
            if not len(kg):
                continue
            step = np.diff(kg) % N
            out["bad"] += int((step == 0).sum())            # repeats
            step = np.where(step == 0, N, step)
            out["lost"] += int((step - 1).sum())
            # The first good packet's loop: the latest whose end had been
            # handed over when it came back.
            j_first = np.searchsorted(handovers, tg[0], side="right")
            avail = j_first * chunk
            loops = (avail - ends[kg[0]]) // L
            a = loops * N + kg[0] + np.concatenate([[0], np.cumsum(step)])
            end = (a // N) * L + ends[a % N]
            j = (end - 1) // chunk
            j = np.minimum(j, len(handovers) - 1)
            out["t"].append(tg)
            out["chunk"].append(j)
            out["latency"].append(tg - handovers[j])
            # Packets due before the first one given back, or after the
            # last.
            out["undelivered"] += count_due(first, int(end[0]))
            out["undelivered"] += count_due(int(end[-1]) + 1, due_samples)
        for key in ("t", "latency", "chunk"):
            out[key] = (np.concatenate(out[key]) if out[key]
                        else np.zeros(0))
        return out


# ------------------------------------------------------------ decoder bytes

def _windows64(stream: np.ndarray) -> list:
    """For each bit shift s in 0..7: the 64-bit big-endian value of the
    circular bit stream starting at bit 8 * j + s, for every byte j."""
    P = len(stream)
    ext = np.concatenate([stream, stream[:9]]).astype(np.uint64)
    v = np.zeros(P, np.uint64)
    for b in range(8):
        v = (v << np.uint64(8)) | ext[b:b + P]
    nxt = ext[8:8 + P]
    return [v] + [(v << np.uint64(s)) | (nxt >> np.uint64(8 - s))
                  for s in range(1, 8)]


def stream_errors(decoded: np.ndarray, stream: np.ndarray,
                  block: int = 8192) -> tuple:
    """The decoder's output bytes of one carrier against the interleaved
    stream sent on it (circular), block by block. A block is compared
    where the one before it ended; where more than a tenth of its bits
    differ there, it is placed by a search for its first 64 bits (any
    bit shift, either polarity: the receiver's framer resolves both). A
    block found nowhere counts as compared where the last one ended, or,
    with no block placed yet, as all wrong. Returns (bit errors, bits
    compared, blocks not found)."""
    windows = _windows64(stream)
    P8 = len(stream) * 8
    sent = np.unpackbits(stream)
    sent = np.concatenate([sent, sent[:block * 8 + 64]])

    def errors_at(where, bits):
        return int(((sent[where[0]:where[0] + len(bits)] ^ where[1])
                    != bits).sum())

    errors = nbits = lost = 0
    where = None
    for o in range(0, len(decoded) - 8, block):
        bits = np.unpackbits(decoded[o:o + block])
        nbits += len(bits)
        e = errors_at(where, bits) if where is not None else len(bits)
        if e > len(bits) // 10:
            head = int(np.frombuffer(decoded[o:o + 8].tobytes(), ">u8")[0])
            found = None
            for pol, w in ((0, head), (1, head ^ 0xFFFFFFFFFFFFFFFF)):
                for sh, v in enumerate(windows):
                    hit = np.flatnonzero(v == np.uint64(w))
                    if len(hit):
                        found = (int(hit[0]) * 8 + sh, pol)
                        break
                if found:
                    break
            if found is None:
                lost += 1
            else:
                where = found
                e = errors_at(where, bits)
        errors += e
        if where is not None:
            where = ((where[0] + len(bits)) % P8, where[1])
    return errors, nbits, lost


# ------------------------------------------------------------- soft layers

def compare_soft(sym, valid, cost, p_sym, p_valid, p_cost) -> float:
    """The share of rows where the program's demod output differs from
    the reference's: in validity, or, where both emit a symbol, in the
    symbol or its cost."""
    p_sym, p_valid, p_cost = (np.asarray(a) for a in (p_sym, p_valid, p_cost))
    both = valid & p_valid
    bad = (valid != p_valid) | (both & ((sym != p_sym) | (cost != p_cost)))
    return float(bad.mean())
