"""PMP zero-copy buffer descriptors (reference leaniiorx.cc:60-151
producer, leanmlmrx.cc:351-376 consumer; a copy of
leansdr_tpu/util/pmp.py).

The reference's homegrown shared-memory transport for SDR-rate data on
PlutoSDR-class hardware: instead of copying samples through a pipe, the
producer publishes {magic 'PMP1', physaddr, size, canary} descriptors
(four little-endian u64, leaniiorx.cc:132-144) and the consumer mmaps
/dev/mem at the physical address and validates that the FIRST u64 of the
buffer still equals the canary captured at publish time
(leanmlmrx.cc:368-372) — i.e. the descriptor is only trusted while the
driver has not recycled the DMA buffer.

The wire format is implemented here byte-for-byte so PMP-emitting
hardware frontends interoperate; `devmem` may point at any mmapable
file, which the simulated AD936x backend (apps/leaniio.py) uses as a
CMA stand-in.
"""

import mmap
import os
import struct
from dataclasses import dataclass

PMP_MAGIC = 0x504D5031            # 'PMP1' (leaniiorx.cc:138)
_FMT = "<QQQQ"                    # magic, physaddr, size, canary: all u64
DESC_SIZE = struct.calcsize(_FMT)  # 32 bytes


@dataclass
class PmpDescriptor:
    physaddr: int
    size: int
    canary: int

    def pack(self) -> bytes:
        return struct.pack(_FMT, PMP_MAGIC, self.physaddr, self.size,
                           self.canary)


def make_descriptor(buf, physaddr: int) -> PmpDescriptor:
    """Producer side: canary = first u64 of the buffer content
    (leaniiorx.cc:141 `pointer.canary = *(volatile uint64_t*)buf`)."""
    head = bytes(memoryview(buf)[:8])
    if len(head) < 8:
        raise ValueError("PMP buffer shorter than the 8-byte canary")
    return PmpDescriptor(physaddr, len(memoryview(buf)),
                         struct.unpack("<Q", head)[0])


def parse(buf: bytes) -> PmpDescriptor:
    magic, phys, size, canary = struct.unpack(_FMT, buf[:DESC_SIZE])
    if magic != PMP_MAGIC:
        raise ValueError(f"bad PMP magic {magic:#x}")
    return PmpDescriptor(phys, size, canary)


def map_buffer(desc: PmpDescriptor, devmem: str = "/dev/mem"):
    """mmap the physical buffer referenced by a descriptor and check
    that its first u64 still matches the canary (leanmlmrx.cc:368-369).
    Raises ValueError on canary mismatch (the reference skips the buffer
    with "PMP: Buffer overrun")."""
    fd = os.open(devmem, os.O_RDONLY)
    try:
        page = mmap.PAGESIZE
        base = desc.physaddr & ~(page - 1)
        off = desc.physaddr - base
        m = mmap.mmap(fd, desc.size + off, mmap.MAP_SHARED,
                      mmap.PROT_READ, offset=base)
    finally:
        os.close(fd)
    canary = struct.unpack_from("<Q", m, off)[0]
    if canary != desc.canary:
        raise ValueError("PMP canary mismatch — buffer overwritten")
    return memoryview(m)[off:off + desc.size]
