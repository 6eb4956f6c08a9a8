"""Time sharding of the recurrent receiver stages with loop-state handoff
between sequential block owners (the counterpart of
leansdr_tpu/parallel/timeshard.py; SURVEY.md section 5.7 / P8).

The feed-forward stages shard trivially (halo.sharded_fir); the PLL /
timing / AGC recurrence cannot, since block s+1's state depends on
block s. The ranks of the `time` group form a ring in rank order:

  * stream j's block s is resident on rank (j + s) mod D: a diagonal
    layout, so consecutive blocks of one stream sit on neighbouring
    ranks;
  * at superstep s every rank demodulates one block of a different
    stream (dsp/receiver.run_chunks: csrc/scan_demod.cu on CUDA), then
    every stream's loop state moves one hop round the ring (d -> d+1,
    a few KB per stream);
  * the state that reaches block s+1's owner has seen every earlier
    sample of that stream, so the recurrence is kept exactly: the
    symbols equal a single-device run's bit for bit.

All D ranks stay busy every superstep once D streams are in flight.
"""

import numpy as np
import torch

from ..dsp import receiver
from . import group as _group


def diagonal_layout(x: np.ndarray, block: int, ra: int) -> np.ndarray:
    """[D, n, 2] stream-major samples -> ins[D, S, block+ra, 2] in the
    diagonal (resident) layout: ins[d, s] = samples
    [s*block, s*block + block + ra) of stream (d - s) mod D."""
    D, n, _ = x.shape
    S = (n - ra) // block
    ins = np.empty((D, S, block + ra, 2), x.dtype)
    for d in range(D):
        for s in range(S):
            j = (d - s) % D
            ins[d, s] = x[j, s * block:s * block + block + ra]
    return ins


def undiagonal(outs: np.ndarray, D: int) -> np.ndarray:
    """[S, D, ...] superstep-major kernel output -> [D, S, ...] in
    stream-major order: stream j's block s was computed on device
    (j + s) mod D."""
    S = outs.shape[0]
    return np.stack([np.stack([outs[s, (j + s) % D] for s in range(S)])
                     for j in range(D)])


def ring_stream_demod(params: receiver.ReceiverParams, group=None):
    """Build the ring-pipelined demodulator.

    Returns fn(tables, state, ins) on rank d of D:
      state: this rank's entry of receiver.init_state(params, D) (every
             leaf [1, ...]): stream d's start state;
      ins:   this rank's [S, B+ra, 2] (or [1, S, B+ra, 2]) slice of
             diagonal_layout(...);
    -> (the state that ends on this rank, [1, ...]; outputs with leaves
        [S, 1, ...], superstep-major: the rank's column of JAX's
        [S, D, ...], joined by mesh.gather_channels(outs, dim=1); see
        undiagonal()).

    After each superstep every leaf of the state goes one hop to rank
    d+1 in sorted-key order (group.shift: paired isend/irecv); at D=1
    the hop is the identity."""

    def fn(tables, state, ins):
        if ins.dim() == 4:
            ins = ins[0]
        if not len(ins):
            raise ValueError("no superstep: ins holds no block")
        keys = sorted(state)
        outs = []
        for xb in ins:
            state, out = receiver.run_chunks(params, tables, state,
                                             xb[None].contiguous())
            moved = _group.shift([state[k].contiguous() for k in keys],
                                 group)
            state = dict(zip(keys, moved))
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs])
                       for k in outs[0]}

    return fn
