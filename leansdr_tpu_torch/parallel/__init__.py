"""Multi-GPU scaling on torch.distributed (the counterpart of
leansdr_tpu/parallel/).

The JAX package shards over a device mesh with `shard_map`; the port runs
one process per rank, each with its own device, and the mesh axes become
process groups:

  * the `channel` axis (parallel/mesh.py): a rank holds a contiguous
    slice of the carriers, C/D of them, and every leaf of the demod state
    and of the input keeps axis 0 = channel, as under P("channel");
    `shard_channels` cuts this rank's slice, `gather_channels` joins
    them in rank order. JAX's `pmean` is an `all_reduce` sum over the
    group divided by D.
  * the `time` axis (parallel/halo.py, parallel/timeshard.py): the ranks
    of the group in rank order form the ring; JAX's `ppermute` with
    perm [(i, i+1 mod D)] is one point-to-point hop to rank r+1
    (`group.shift`).
  * the multi-host fleet (parallel/multihost.py, the counterpart of
    tools/dcn_demo.py): one process per rank over its own carriers,
    counts reduced across ranks.

Each rank's device is `cuda:(rank % device_count)` (or the CPU where the
caller asks for it); the backend is NCCL unless the caller asks for gloo.
NCCL needs a GPU per rank, so ranks that would share a card under NCCL
raise before the process group is formed; under gloo, which has no
point-to-point transfers of CUDA tensors, the collectives stage their
tensors through host memory (`group.py`).

A sharded run starts from the same state as an unsharded one: the
receiver state that `convert.from_jax_checkpoint` makes from a JAX
checkpoint is a dict of [C, ...] tensors, and `mesh.shard_channels` of it
is each rank's start. No conversion of its own is needed.
"""
