"""The collectives the batch-global losses and the training step use.

Each is the identity in a single process (no process group, or a world of
one), so single-process code runs them unchanged.  They are built on
``all_reduce``, ``all_gather`` and ``broadcast`` alone, which gloo also
runs on CUDA tensors.  Nothing here records a gradient: a global term is
computed from gathered detached values, and each rank differentiates only
its own share (``train/losses.py``); an autograd all-gather would hand
every rank the gradient of every rank's copy of that term, multiplied by
the world size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` itself in a
    single process)."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order (``t``
    itself in a single process).  Every rank passes the same shape."""
    if world_size() == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def barrier(device: torch.device) -> None:
    """Wait for every rank (a no-op in a single process)."""
    if world_size() == 1:
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
