"""The process group and the data-parallel helpers (port of
``stmask_tpu/parallel/mesh.py``).

The JAX package trains SPMD over a device mesh with the batch sharded
over its ``data`` axis.  Here each process drives one device and holds
its shard of the global batch (the clips its
``ClipLoader(num_shards=world, shard_id=rank)`` loads); the batch-global
loss terms gather what they need (``train/losses.py``) and the training
step sums the gradients over the ranks (``train/train_step.py``), so that
W ranks compute the single-process step over the rank-ordered
concatenation of their shards.  The layout is the process group's:
``collectives.world_size()`` ranks, this one ``collectives.rank()``.

    torchrun --nproc_per_node=N -m stmask_torch.train ...

``initialize_multihost`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and opens the process group: NCCL when every rank of the
host has a card of its own (``cuda:LOCAL_RANK``), gloo for CPU ranks and
for several ranks on one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import rank, world_size

# How long a collective may wait for the other ranks before the group
# aborts.  The training loop's ranks wait at a barrier while rank 0
# validates over a whole split or saves a checkpoint, which can outlast
# torch's default (10 minutes under NCCL's watchdog).
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def initialize_multihost(device: torch.device | str = 'cuda'
                         ) -> torch.device:
    """Open the process group from torchrun's environment; returns this
    rank's device.  A world of one opens nothing and returns
    ``resolve_device(device)``.  On ``cuda`` a rank takes
    ``cuda:LOCAL_RANK`` when the host has a card for each of its ranks,
    else they share ``cuda:0``."""
    env = os.environ
    world = int(env.get('WORLD_SIZE', 1))
    if world <= 1:
        return resolve_device(device)
    process_id = int(env['RANK'])
    local_rank = int(env.get('LOCAL_RANK', process_id))
    local_world = int(env.get('LOCAL_WORLD_SIZE', world))
    dev = resolve_device(device)
    backend = 'gloo'
    if dev.type == 'cuda':
        if torch.cuda.device_count() >= local_world:
            dev = torch.device('cuda', local_rank)
            backend = 'nccl'
        else:
            dev = torch.device('cuda', 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
        f"{env.get('MASTER_PORT', '29500')}", world_size=world,
        rank=process_id, timeout=GROUP_TIMEOUT)
    print(f'[parallel] rank {process_id} of {world} on {dev}, '
          f'backend {backend}', flush=True)
    return dev


def shard_batch(batch: Any, device: torch.device | str) -> Any:
    """This rank's share of a global batch (a dict of arrays or one array)
    on ``device``: the contiguous slice of the leading dimension that the
    rank holds in rank order."""
    w, r = world_size(), rank()

    def put(x):
        x = torch.as_tensor(x)
        n = x.shape[0] // w
        if n * w != x.shape[0]:
            raise ValueError(f'shard_batch: a batch of {x.shape[0]} over '
                             f'{w} ranks')
        return x[r * n:(r + 1) * n].to(device, non_blocking=True)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def replicate(state):
    """Rank 0's training state on every rank: its parameters and buffers,
    momentum, optimizer count and step are broadcast in place.  Returns the
    state (a single process returns it as it is)."""
    if world_size() == 1:
        return state
    tensors = ([t.data for t in state.model.parameters()]
               + list(state.model.buffers()) + list(state.momentum)
               + [state.count])
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    step = torch.tensor([state.step], dtype=torch.long,
                        device=state.count.device)
    dist.broadcast(step, src=0)
    return state._replace(step=int(step))
