"""torch.distributed plumbing of the parallel modules: forming the
process group with each rank on its device, and the collectives they
use, with CUDA tensors staged through host memory under gloo.

NCCL is the default backend, on CUDA. It needs one GPU per rank: ranks
that would share a card raise before `init_process_group` (NCCL would
fail on the duplicate GPU anyway). gloo takes ranks that share a card,
or CPU ranks where the caller asks for them; its point-to-point transfers
take no CUDA tensors, so every transfer here copies a CUDA tensor to the
host first and the result back (`_wire`).
"""

import datetime

import torch
import torch.distributed as dist

from .. import device as _dev

INIT_TIMEOUT_S = 60


def rank_device(rank: int, device=None) -> torch.device:
    """The device of `rank`: `cuda:(rank % device_count)` by default (CUDA
    without a GPU raises), or the CPU if the caller asks for it."""
    dev = _dev.resolve_device(device)
    if dev.type == "cuda" and (device is None
                               or torch.device(device).index is None):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init(rank: int, world_size: int, init_method: str, backend: str = "nccl",
         device=None) -> torch.device:
    """Join the default process group as `rank` of `world_size` ranks,
    all on this host, within INIT_TIMEOUT_S, and return this rank's
    device (rank_device).

    Raises before forming the group when NCCL is asked for with more
    ranks than this host has cards, or on the CPU."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dev = rank_device(rank, device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on CUDA devices; "
                             "use backend='gloo' for CPU ranks")
        cards = torch.cuda.device_count()
        if world_size > cards:
            names = ", ".join(torch.cuda.get_device_name(i)
                              for i in range(cards))
            raise RuntimeError(
                f"NCCL with {world_size} ranks on this host's {cards} "
                f"card(s) ({names}): NCCL needs one GPU per rank; use "
                "backend='gloo' for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return dev


def size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


# Element types the backends do not carry (gloo has no bool, neither has
# 16-bit integers), sent widened and narrowed again on arrival.
_WIRE = {torch.bool: torch.uint8, torch.int16: torch.int32,
         torch.uint16: torch.int32}


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """t as the backend takes it: under gloo a host copy of a CUDA
    tensor; a type in _WIRE widened; contiguous."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.detach().to("cpu", copy=True)
    if t.dtype in _WIRE:
        t = t.to(_WIRE[t.dtype])
    return t.contiguous()


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of t over the group's ranks (a new tensor on t's device)."""
    s = _wire(t, group).clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return _unwire(s, t)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's t (same shape on every rank) joined along `dim` in
    rank order (a new tensor on t's device)."""
    s = _wire(t, group)
    parts = [torch.empty_like(s) for _ in range(size(group))]
    dist.all_gather(parts, s, group=group)
    return _unwire(torch.cat(parts, dim), t)


def shift(tensors: list, group=None, wrap: bool = True) -> list:
    """One hop along the ranks in rank order: rank r sends each tensor to
    rank r+1 and returns those of rank r-1 (JAX's ppermute with perm
    [(i, i+1 mod D)]). With wrap=False the last rank sends nothing and
    rank 0 gets zeros. All ranks must pass tensors of the same shapes
    and types, in the same order.

    The transfers go as one batch of paired isend/irecv, so no rank
    blocks in a send while its neighbour does too. At one rank the hop is
    the identity (torch refuses a send to oneself)."""
    D, r = size(group), rank(group)
    if D == 1:
        return list(tensors) if wrap else [torch.zeros_like(t)
                                           for t in tensors]
    dst = (r + 1) % D if wrap or r + 1 < D else None
    src = (r - 1) % D if wrap or r > 0 else None
    ops, bufs = [], []
    for tag, t in enumerate(tensors):
        s = _wire(t, group)
        buf = torch.empty_like(s)
        bufs.append(buf)
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, s, _global(group, dst), group,
                                  tag))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, buf, _global(group, src), group,
                                  tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if src is None:
        return [torch.zeros_like(t) for t in tensors]
    return [_unwire(b, t) for b, t in zip(bufs, tensors)]
