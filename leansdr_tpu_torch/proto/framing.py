"""MPEG-TS bit alignment, polarity and packet framing (a copy of
leansdr_tpu/proto/framing.py: the single-carrier receiver's host FSM).

Mirrors mpeg_sync (reference dvb.h:712-891): searching mode scans
scan_syncs=8 packets at all 8 bit phases and all 204 byte offsets for
want_syncs=4 agreeing 0x47/0xB8 start codes, detects polarity and the
position in the 8-packet sync-inversion cycle; decoding mode re-shifts each
packet, applies polarity, and unlocks after lock_timeout=4 packets without
a good sync byte.

The search is expressed as vectorized correlations (shift + compare +
count over a [8 bitphases, 204 offsets, 8 packets] tensor); the FSM runs at
packet rate on the host side of the chunk pipeline.
"""

import numpy as np

RS_SIZE = 204
MPEG_SYNC = 0x47
MPEG_SYNC_INV = 0xB8


def bitshift_stream(data: np.ndarray, bitphase: int) -> np.ndarray:
    """out[i] = ((data[i]<<8 | data[i+1]) >> bitphase) & 0xff for i+1 < len.

    Matches the reference's left-to-right shifting (dvb.h:801-807):
    bitphase 0 returns data[1:], phase 8 would return data[:-1].
    """
    w = (data[:-1].astype(np.uint16) << 8) | data[1:]
    return ((w >> bitphase) & 0xFF).astype(np.uint8)


class MpegSync:
    """Stateful framing FSM over a shifted-byte backlog."""

    def __init__(self, fastlock: bool = False, scan_syncs: int = 8,
                 want_syncs: int = 4, lock_timeout: int = 4,
                 resync_period: int = 1, on_next_sync=None):
        self.scan_syncs = scan_syncs
        self.want_syncs = want_syncs
        self.lock_timeout = lock_timeout
        self.fastlock = fastlock
        self.resync_period = resync_period
        self.on_next_sync = on_next_sync   # callback into the deconvolver
        self.polarity = 0
        self.bitphase = 0
        self.synchronized = False
        self.next_sync_count = 0
        self.resync_phase = 0
        self.phase8 = -1
        self.lock_timeleft = 0
        self.locktime = 0
        # Bounded metric outputs (long-running receivers must not grow
        # host memory with stream length): lock transitions since the
        # consumer last cleared, capped; locktime_count is the monotonic
        # number of locktime ticks, with `locktime` their latest value.
        from collections import deque
        self.lock_events = deque(maxlen=256)   # (state 0|1) transitions
        self.locktime_count = 0

    # -- searching ---------------------------------------------------------

    def _search_sync(self, data: np.ndarray):
        """Try to lock within `data` (>= chunk+1 bytes) at self.bitphase.

        Returns byte offset consumed to reach the first start code, or None.
        Mirrors search_sync (dvb.h:798-840).
        """
        chunk = RS_SIZE * self.scan_syncs
        shifted = bitshift_stream(data[:chunk + 1], self.bitphase)  # [chunk]
        grid = shifted.reshape(self.scan_syncs, RS_SIZE)            # [8,204]
        # Vectorized over all 204 offsets (the reference's offset loop,
        # dvb.h:809-838, with identical selection semantics).
        pos = grid == MPEG_SYNC                                     # [8,204]
        neg = grid == MPEG_SYNC_INV
        nsyncs_p = pos.sum(axis=0)
        nsyncs_n = neg.sum(axis=0)
        j = np.arange(self.scan_syncs)[:, None]
        last_p = np.where(pos, j, -1).max(axis=0)       # last j with 0x47
        last_n = np.where(neg, j, -1).max(axis=0)
        phase8_n = np.where(last_p >= 0, (8 - last_p) & 7, -1)
        phase8_p = np.where(last_n >= 0, (8 - last_n) & 7, -1)
        use_p = nsyncs_p > nsyncs_n
        nsyncs = np.where(use_p, nsyncs_p, nsyncs_n)
        phase8 = np.where(use_p, phase8_p, phase8_n)
        ok = (nsyncs >= self.want_syncs) & (phase8 >= 0)
        hits = np.nonzero(ok)[0]
        if len(hits) == 0:
            # The reference updates polarity/phase8 even on failed
            # offsets; reproduce the final (offset 203) values.
            self.polarity = 0 if use_p[-1] else 0xFF
            self.phase8 = int(phase8[-1])
            return None
        i = int(hits[0])
        self.polarity = 0 if use_p[i] else 0xFF
        self.phase8 = int(phase8[i])
        consumed = i
        if i == 0:
            # Avoid fixpoint detection in the scheduler (dvb.h:826-829):
            # skip one packet instead.
            consumed = RS_SIZE
            self.phase8 = (self.phase8 + 1) & 7
        self.synchronized = True
        self.lock_timeleft = self.lock_timeout
        self.locktime = 0
        self.lock_events.append(1)
        return consumed

    def _run_searching(self, data: np.ndarray) -> int:
        """Non-fastlock search (dvb.h:755-779). Returns bytes consumed."""
        chunk = RS_SIZE * self.scan_syncs
        consumed = 0
        next_sync = False
        while len(data) - consumed >= chunk + 1:
            r = self._search_sync(data[consumed:])
            if r is not None:
                return consumed + r
            consumed += chunk
            self.bitphase += 1
            if self.bitphase == 8:
                self.bitphase = 0
                next_sync = True
        if next_sync:
            self.next_sync_count += 1
            if self.next_sync_count >= 3:
                self.next_sync_count = 0
                if self.on_next_sync:
                    self.on_next_sync()
        return consumed

    def _run_searching_fast(self, data: np.ndarray) -> int:
        """Fastlock search (dvb.h:782-796). Returns bytes consumed."""
        chunk = RS_SIZE * self.scan_syncs
        consumed = 0
        while len(data) - consumed >= chunk + 1:
            if self.resync_phase == 0:
                for bp in range(8):
                    self.bitphase = bp
                    r = self._search_sync(data[consumed:])
                    if r is not None:
                        return consumed + r
            consumed += RS_SIZE
            self.resync_phase += 1
            if self.resync_phase >= self.resync_period:
                self.resync_phase = 0
        return consumed

    # -- decoding ----------------------------------------------------------

    def _run_decoding(self, data: np.ndarray):
        """Emit aligned packets until data runs out or we unlock
        (dvb.h:842-874). Returns (packets [n,204], consumed).

        Vectorized over the whole block (SURVEY.md 2.10 P2): all packets
        are shifted/polarity-fixed at once; the per-packet lock-timeout
        FSM reduces to finding the first run of `lock_timeout` bad sync
        bytes (with the incoming `lock_timeleft` as carried-in bad
        credit), identical to the reference's sequential loop.
        """
        n_all = (len(data) - 1) // RS_SIZE
        if n_all <= 0:
            return np.empty((0, RS_SIZE), np.uint8), 0
        seg = data[:n_all * RS_SIZE + 1]
        pkts = (bitshift_stream(seg, self.bitphase) ^ self.polarity
                ).reshape(n_all, RS_SIZE)
        phase8 = (self.phase8 + np.arange(n_all)) & 7
        expected = np.where(phase8 != 0, MPEG_SYNC, MPEG_SYNC_INV)
        good = pkts[:, 0] == expected
        # timeleft recurrence t_i = (timeout if good_i else t_{i-1}) - 1,
        # carried in as t0, closed-form via last-good index g_i:
        #   t_i = timeout - 1 - (i - g_i)   if any good at g_i <= i
        #   t_i = t0 - (i + 1)              before the first good
        # Unlock at the first i with t_i == 0 (that packet is emitted).
        t0 = self.lock_timeleft
        idx = np.arange(n_all)
        g = np.maximum.accumulate(np.where(good, idx, -1))
        t_after = np.where(g >= 0, self.lock_timeout - 1 - (idx - g),
                           t0 - (idx + 1))
        hits = np.nonzero(t_after <= 0)[0]
        unlock = len(hits) > 0
        n_emit = int(hits[0]) + 1 if unlock else n_all
        pkts = pkts[:n_emit]
        self.locktime_count += n_emit
        self.locktime += n_emit
        self.phase8 = int((self.phase8 + n_emit) & 7)
        if unlock:
            self.synchronized = False
            self.next_sync_count = 0
            self.lock_events.append(0)
        self.lock_timeleft = int(t_after[n_emit - 1])
        return pkts, n_emit * RS_SIZE

    def process(self, data: np.ndarray):
        """Feed a byte backlog; returns (packets [n,204], consumed bytes).

        The caller keeps unconsumed bytes for the next call.
        """
        packets = []
        consumed = 0
        while True:
            avail = data[consumed:]
            if self.synchronized:
                pkts, c = self._run_decoding(avail)
                if len(pkts):
                    packets.append(pkts)
                consumed += c
                if self.synchronized:
                    break         # ran out of data while locked
            else:
                if self.fastlock:
                    c = self._run_searching_fast(avail)
                else:
                    c = self._run_searching(avail)
                consumed += c
                if not self.synchronized:
                    break         # ran out of data while searching
        if packets:
            return np.concatenate(packets, axis=0), consumed
        return np.empty((0, RS_SIZE), np.uint8), consumed
