"""HDLC deframing and the IESS-308/ETR 192 descrambler (the reference's
alternate protocol path, hdlc.h + iess.h; a copy of
leansdr_tpu/proto/hdlc.py).

hdlc_dec (hdlc.h:27-147): bit-level flag/stuffing/abort detection with
CRC16-CCITT (poly 0x8408 reflected, init 0xffff, check 0x0f47).
hdlc_sync (hdlc.h:152-306): 2-polarity decoder election over NERRHIST=2
error windows, periodic resync like the other sync blocks.
etr192_descrambler (iess.h:29-71): 20-bit self-synchronizing shift
register with a 5-bit counter and overflow injection.

The descrambler and the HDLC bit machine are per-bit recurrences at the
byte-stream rate (already ~100x below sample rate); they run as compact
Python/NumPy state machines on the host, with the descrambler vectorized
where its recurrence allows.
"""

import numpy as np

CRC16_INIT = 0xFFFF
CRC16_POLY = 0x8408
CRC16_CHECK = 0x0F47


def _crc16_table():
    tab = np.zeros(256, np.uint16)
    for d in range(256):
        crc = d
        for _ in range(8):
            crc = (crc >> 1) ^ CRC16_POLY if (crc & 1) else (crc >> 1)
        tab[d] = crc
    return tab


_CRC_TAB = _crc16_table()


class HdlcDec:
    """hdlc_dec: stateful bit-level HDLC deframer."""

    def __init__(self, minframesize: int, maxframesize: int, invert: bool):
        self.minframesize = minframesize
        self.maxframesize = maxframesize
        self.invertmask = 0xFF if invert else 0
        self.reset()

    def reset(self):
        self.shiftreg = 0
        self.inframe = False
        self.byte_out = 0
        self.nbits_out = 0
        self.framesize = 0
        self.crc16 = CRC16_INIT
        self.framebuf = np.zeros(self.maxframesize, np.uint8)

    def _begin_frame(self):
        self.framesize = 0
        self.crc16 = CRC16_INIT

    def decode(self, data: np.ndarray):
        """Decode packed-bit bytes; yields (frame bytes) per valid frame.

        Returns (frames list, hdlc_errors, fcs_errors).
        """
        frames = []
        hdlc_errors = 0
        fcs_errors = 0
        for byte in np.asarray(data, np.uint8):
            byte_in = int(byte) ^ self.invertmask
            for _ in range(8):
                bit_in = byte_in & 128
                byte_in = (byte_in << 1) & 0xFF
                self.shiftreg = ((self.shiftreg >> 1) | bit_in) & 0xFF
                if not self.inframe:
                    if self.shiftreg == 0x7E:
                        self.inframe = True
                        self.nbits_out = 0
                        self._begin_frame()
                else:
                    if (self.shiftreg & 0xFE) == 0x7C:
                        pass          # unstuff
                    elif self.shiftreg == 0x7E:
                        if self.nbits_out != 7:
                            hdlc_errors += 1
                        else:
                            crc = self.crc16 ^ 0xFFFF
                            if (self.framesize < 2
                                    or self.framesize < self.minframesize
                                    or crc != CRC16_CHECK):
                                hdlc_errors += 1
                                if self.framesize >= self.minframesize:
                                    fcs_errors += 1
                            else:
                                frames.append(
                                    self.framebuf[:self.framesize - 2].copy())
                        self.nbits_out = 0
                        self._begin_frame()
                    elif self.shiftreg == 0xFE:
                        if self.framesize:
                            hdlc_errors += 1
                        self.inframe = False
                    else:
                        self.byte_out = ((self.byte_out >> 1) | bit_in) & 0xFF
                        self.nbits_out += 1
                        if self.nbits_out == 8:
                            if self.framesize < self.maxframesize:
                                self.framebuf[self.framesize] = self.byte_out
                                self.framesize += 1
                                self.crc16 = ((self.crc16 >> 8)
                                              ^ _CRC_TAB[(self.crc16
                                                          ^ self.byte_out)
                                                         & 0xFF])
                            self.nbits_out = 0
        return frames, hdlc_errors, fcs_errors


class HdlcSync:
    """hdlc_sync: 2-polarity election over chunks of maxframesize+2."""

    NSYNCS = 2
    NERRHIST = 2

    def __init__(self, minframesize: int, maxframesize: int,
                 fastlock: bool = False, header16: bool = False):
        self.chunk_size = maxframesize + 2
        self.decs = [HdlcDec(minframesize, maxframesize, s != 0)
                     for s in range(self.NSYNCS)]
        self.errhist = np.zeros((self.NSYNCS, self.NERRHIST), np.int64)
        self.errslot = 0
        self.cur_sync = 0
        self.resync_phase = 0
        self.resync_period = 1 if fastlock else 32
        self.header16 = header16
        self.lock_state = False
        self.framecount = 0
        self.fcserrcount = 0
        self.backlog = np.empty(0, np.uint8)
        # -d glyphs (hdlc.h:73-96): '_' good frame, '!' bad FCS,
        # '^' framing error; emitted for the elected polarity only.
        self.debug = False

    def process(self, data: np.ndarray) -> np.ndarray:
        self.backlog = np.concatenate([self.backlog, data])
        out = []
        while len(self.backlog) >= self.chunk_size:
            chunk = self.backlog[:self.chunk_size]
            self.backlog = self.backlog[self.chunk_size:]
            if self.resync_phase == 0:
                for s in range(self.NSYNCS):
                    if s != self.cur_sync:
                        self.decs[s].reset()
                    frames, herr, ferr = self.decs[s].decode(chunk)
                    self.errhist[s, self.errslot] = herr
                    if s == self.cur_sync:
                        self._glyphs(frames, herr, ferr)
                        self._emit(frames, ferr, out)
                self.errslot = (self.errslot + 1) % self.NERRHIST
                total = self.errhist.sum(axis=1)
                best = int(np.argmin(total))
                if total[best] < total[self.cur_sync]:
                    self.lock_state = False
                    self.cur_sync = best
            else:
                frames, herr, ferr = self.decs[self.cur_sync].decode(chunk)
                self.errhist[self.cur_sync, self.errslot] = herr
                self._glyphs(frames, herr, ferr)
                self._emit(frames, ferr, out)
            self.resync_phase += 1
            if self.resync_phase >= self.resync_period:
                self.resync_phase = 0
        return (np.concatenate(out) if out else np.empty(0, np.uint8))

    def _glyphs(self, frames, hdlc_errors, fcs_errors):
        if self.debug:
            import sys
            sys.stderr.write("_" * len(frames) + "!" * fcs_errors
                             + "^" * (hdlc_errors - fcs_errors))
            sys.stderr.flush()

    def _emit(self, frames, fcs_errors, out):
        for f in frames:
            self.lock_state = True
            self.framecount += 1
            if self.header16:
                out.append(np.array([len(f) >> 8, len(f) & 0xFF], np.uint8))
            out.append(f)
        self.fcserrcount += fcs_errors
        self.framecount += fcs_errors


def etr192_descramble(data: np.ndarray, shiftreg: int = 0,
                      counter: int = 0):
    """etr192_descrambler (iess.h:39-64) over packed-bit bytes.

    Returns (descrambled bytes, shiftreg, counter) for streaming.
    """
    out = np.empty(len(data), np.uint8)
    for i, byte in enumerate(np.asarray(data, np.uint8)):
        byte_in = int(byte)
        byte_out = 0
        for _ in range(8):
            bit_in = (byte_in >> 7) & 1
            byte_in = (byte_in << 1) & 0xFF
            reset_counter = (shiftreg ^ (shiftreg >> 8)) & 1
            counter_overflow = 1 if counter == 31 else 0
            taps = (shiftreg >> 2) ^ (shiftreg >> 19)
            bit_out = (taps ^ counter_overflow ^ bit_in ^ 1) & 1
            shiftreg = ((shiftreg << 1) | bit_in) & 0xFFFFFFFF
            counter = 0 if reset_counter else (counter + 1) & 31
            byte_out = ((byte_out << 1) | bit_out) & 0xFF
        out[i] = byte_out
    return out, shiftreg, counter


def etr192_scramble(data: np.ndarray, shiftreg: int = 0, counter: int = 0):
    """The scrambler direction (iess.h:54-55): feedback from bit_out."""
    out = np.empty(len(data), np.uint8)
    for i, byte in enumerate(np.asarray(data, np.uint8)):
        byte_in = int(byte)
        byte_out = 0
        for _ in range(8):
            bit_in = (byte_in >> 7) & 1
            byte_in = (byte_in << 1) & 0xFF
            reset_counter = (shiftreg ^ (shiftreg >> 8)) & 1
            counter_overflow = 1 if counter == 31 else 0
            taps = (shiftreg >> 2) ^ (shiftreg >> 19)
            bit_out = (taps ^ counter_overflow ^ bit_in ^ 1) & 1
            shiftreg = ((shiftreg << 1) | bit_out) & 0xFFFFFFFF
            counter = 0 if reset_counter else (counter + 1) & 31
            byte_out = ((byte_out << 1) | bit_out) & 0xFF
        out[i] = byte_out
    return out, shiftreg, counter
