"""Double-buffered host->device ingest (the counterpart of
leansdr_tpu/util/ingest.py; SURVEY.md 2.10 P7: the replacement for the
reference's Unix-pipe sample transport).

A background thread stages chunk k+1 while the consumer's device work
runs on chunk k. On a CUDA device each chunk is written into one of
`depth + 1` pinned host buffers, copied to the card with
`non_blocking=True` on a dedicated copy stream, and an event is recorded
after the copy. The iterator makes the consumer's current stream wait on
that event before it yields the chunk, so the copy overlaps whatever the
consumer has queued, and a pinned buffer is written again only after its
last copy's event has completed. On the CPU the chunks come out as CPU
tensors, in order.

Unlike the JAX feeder, an exception raised by the source (or by the
staging) is raised again in the consumer, not taken for the end of the
stream.
"""

import queue
import threading

import numpy as np
import torch

from .. import device as _dev

_END = object()


class DeviceFeeder:
    """Iterate device-resident chunks, `depth` of them staged ahead.

    chunks: iterable of NumPy arrays (or anything np.asarray takes).
    device: where the chunks go (default CUDA; CUDA without a GPU
    raises)."""

    def __init__(self, chunks, device=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth={depth}: need at least 1")
        self.device = _dev.resolve_device(device)
        self.depth = depth
        self._q = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(
            target=self._pump, args=(iter(chunks),), daemon=True)
        self._thread.start()

    def _pump(self, it):
        try:
            if self.device.type == "cuda":
                self._pump_cuda(it)
            else:
                for a in it:
                    self._q.put((torch.from_numpy(np.array(a)), None))
        except Exception as e:            # raised again in the consumer
            self._q.put(e)
        else:
            self._q.put(_END)

    def _pump_cuda(self, it):
        dev = self.device
        torch.cuda.set_device(dev)
        stream = torch.cuda.Stream(dev)
        pinned = [None] * (self.depth + 1)      # flat uint8 buffers
        copied = [None] * (self.depth + 1)      # each buffer's last copy
        for k, a in enumerate(it):
            a = np.ascontiguousarray(a)
            slot = k % len(pinned)
            if copied[slot] is not None:
                copied[slot].synchronize()      # its last copy is done
            if pinned[slot] is None or pinned[slot].numel() < a.nbytes:
                pinned[slot] = torch.empty(a.nbytes, dtype=torch.uint8,
                                           pin_memory=True)
            host = torch.from_numpy(a)
            buf = pinned[slot][:a.nbytes].view(host.dtype).view(host.shape)
            buf.copy_(host)
            with torch.cuda.stream(stream):
                out = torch.empty(host.shape, dtype=host.dtype, device=dev)
                out.copy_(buf, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            copied[slot] = done
            self._q.put((out, done))
        stream.synchronize()            # the pinned buffers outlive copies

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            t, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                # t was allocated on the copy stream: keep its memory from
                # being reused there while the consumer's work reads it.
                t.record_stream(consumer)
            yield t


def read_chunks(f, nbytes: int):
    """Yield successive byte chunks from a binary stream."""
    while True:
        b = f.read(nbytes)
        if not b:
            return
        yield b
