"""Channel sharding over a `channel` group (the counterpart of
leansdr_tpu/parallel/mesh.py).

The fleet's dominant parallel axis is the channel: independent carriers
demodulated in lockstep. Each rank owns a contiguous slice of the
carriers; the scan demod runs wholly on the rank's own slice
(dsp/receiver.run_chunks: csrc/scan_demod.cu on CUDA), and only scalar
metrics (lock quality, the MER the scan election reads) cross ranks.

A sharded run starts where an unsharded one would: `shard_channels` of
the state dict that `convert.from_jax_checkpoint` (through
`MultiDvbsReceiver.load_state`) or `receiver.init_state` makes.
"""

import torch

from ..dsp import receiver
from . import group as _group


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_channels(tree, group=None):
    """This rank's slice of every [C, ...] leaf of `tree` (dicts, lists
    and tuples of tensors): channels [r*C/D, (r+1)*C/D) of D ranks. C
    must be a multiple of D, as under JAX's P("channel")."""
    D, r = _group.size(group), _group.rank(group)

    def cut(t):
        C = t.shape[0]
        if C % D:
            raise ValueError(f"{C} channels do not split {D} ways")
        return t[r * (C // D):(r + 1) * (C // D)]
    return _tree_map(cut, tree)


def gather_channels(tree, group=None, dim: int = 0):
    """Every rank's `tree` joined leaf by leaf along `dim` (the channel
    axis) in rank order; every rank gets the whole."""
    return _tree_map(lambda t: _group.all_gather(t, group, dim), tree)


def sharded_demod_step(params: receiver.ReceiverParams, group=None):
    """Build the sharded demod step.

    Returns step(tables, state, x) -> (state, outputs, mean_mer): state
    and x ([C/D, n, 2] float32) are this rank's channel slice, tables are
    whole on every rank; the scan demod runs on the slice, and mean_mer is
    the group's mean of each rank's mean MER (JAX's pmean: an all_reduce
    sum over D ranks, divided by D), a 0-d tensor on x's device."""

    def step(tables, state, x):
        state, out = receiver.run_chunks(params, tables, state, x)
        total = _group.all_reduce_sum(out["mer"].mean(), group)
        return state, out, total / _group.size(group)

    return step
