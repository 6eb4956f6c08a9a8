"""Overlap-save FIR filtering sharded over a `time` group (the
counterpart of leansdr_tpu/parallel/halo.py).

When one channel must exceed one card's throughput, its sample stream is
cut into contiguous time blocks, one per rank in rank order, and the
feed-forward filter stages take the ncoeffs-1-sample boundary overlap
from the left neighbour (one point-to-point hop; zeros at the stream
head). Each rank then filters its extended block with the real-tap FIR
kernel (dsp/fir_kernel.fir, csrc/fir.cu `fir_launch` on CUDA) and drops
the first ncoeffs-1 outputs.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..dsp import fir_kernel
from . import group as _group


def make_time_group(ranks=None):
    """The `time` group: `ranks` in rank order (every rank must call
    this, as torch.distributed.new_group requires), or None, the default
    group of all ranks."""
    return None if ranks is None else dist.new_group(list(ranks))


def sharded_fir(coeffs, group=None):
    """Build the time-sharded FIR y[t] = sum_k c[k] x[t-k].

    Returns fir(xb): xb is this rank's [2, n/D] float32 block (re, im
    rows) of a complex stream whose blocks the group's ranks hold in rank
    order; the result is this rank's [2, n/D] block of the causal
    convolution, conv(x, c)[:n] of the whole stream. Each rank sends its
    last ncoeffs-1 samples to rank r+1; rank 0 takes zeros, and the last
    rank's tail goes nowhere. Every output is summed in tap order from
    the same samples as an unsharded `fir_kernel.fir` over the whole
    stream, so the two are equal bit for bit."""
    c = np.asarray(coeffs, np.float32)
    if c.ndim != 1 or not len(c):
        raise ValueError("coeffs: a non-empty 1-D array of real taps")
    nc = len(c)
    taps = {}

    def fir(xb: torch.Tensor) -> torch.Tensor:
        if xb.dim() != 2 or xb.shape[0] != 2:
            raise ValueError(f"block {tuple(xb.shape)}: expected [2, n/D]")
        if xb.shape[1] < nc - 1:
            raise ValueError(f"block of {xb.shape[1]} samples: the halo "
                             f"needs at least {nc - 1}")
        if xb.device not in taps:
            taps[xb.device] = torch.from_numpy(c).to(xb.device)
        xb = xb.contiguous()
        if nc == 1:
            return fir_kernel.fir(xb, taps[xb.device])
        left, = _group.shift([xb[:, xb.shape[1] - (nc - 1):]], group,
                             wrap=False)
        ext = torch.cat([left, xb], dim=1)
        return fir_kernel.fir(ext, taps[xb.device])[:, nc - 1:]

    return fir
