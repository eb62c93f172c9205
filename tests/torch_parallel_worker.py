"""One rank of the port's data-parallel training step, for
``tests/test_torch_parallel.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_worker.py WORKDIR

The rank opens its gloo group from that environment
(``parallel.initialize_multihost`` on the CPU), builds the reduced
flagship (``reduce``) from ``WORKDIR/init.pt`` (rank 1 first shifts
every parameter, which ``parallel.replicate`` must undo), takes its share
of each global batch in ``WORKDIR/batches.pt`` and runs one training step
on each.  It writes ``WORKDIR/rank<r>.pt``: the metrics of every step,
the largest difference of its gradients and parameters from rank 0's,
whether each step left the parameters unchanged, the optimizer count, and
on rank 0 the raw gradients and the parameters after each of the first
``KEEP`` steps and the momentum after the first.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the reduced flagship of tests/test_multiprocess.py; the gradient clip
# engages on its random weights
KW = dict(img_w=128, img_h=96, max_gt_per_frame=4, masks_to_train=16,
          extra_layers=(1, 1, 1, 1), lr=1e-2, lr_warmup_until=0,
          grad_clip_norm=1.0)


KEEP = 2


def reduce(cfg):
    """The reduced flagship, of either package's config."""
    return cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, layers=(1, 1, 1, 1), dcn_layers=(0, 1, 1, 1),
        dcn_interval=3), **KW)


# objects (ref-frame box, track id); the next frame moves each box right
OBJECTS = {1: (0.1, 0.1, 0.45, 0.55), 2: (0.55, 0.45, 0.9, 0.9),
           3: (0.3, 0.5, 0.7, 0.95), 4: (0.05, 0.6, 0.35, 0.95)}
# ids of each clip's two frames: rank 0's shard (clips 0, 1) holds more
# instances than rank 1's (clips 2, 3), and the ids recur across shards
CLIPS = (((1, 2, 4), (1, 3, 4)), ((2, 3), (2, 3)),
         ((1,), (1,)), ((3, 4), (4,)))


def global_batch(cfg, seed):
    """Four clips of two frames in the training step's batch format."""
    rng = np.random.RandomState(seed)
    n, g, hp, wp = len(CLIPS), cfg.max_gt_per_frame, cfg.pad_h // 4, \
        cfg.pad_w // 4
    batch = {'images': rng.randn(n, 2, cfg.pad_h, cfg.pad_w,
                                 3).astype(np.float32),
             'boxes': np.zeros((n, 2, g, 4), np.float32),
             'labels': np.zeros((n, 2, g), np.int32),
             'ids': np.zeros((n, 2, g), np.int32),
             'valid': np.zeros((n, 2, g), bool),
             'masks_proto': np.zeros((n, 2, g, hp, wp), np.uint8)}
    for c, frames in enumerate(CLIPS):
        for f, frame_ids in enumerate(frames):
            for j, gid in enumerate(frame_ids):
                x1, y1, x2, y2 = OBJECTS[gid]
                shift = 0.03 * f + 0.01 * rng.rand()
                x1, x2 = x1 + shift, min(x2 + shift, 1.0)
                batch['boxes'][c, f, j] = [x1, y1, x2, y2]
                batch['labels'][c, f, j] = gid + 1
                batch['ids'][c, f, j] = gid
                batch['valid'][c, f, j] = True
                batch['masks_proto'][c, f, j, int(y1 * hp):int(y2 * hp),
                                     int(x1 * wp):int(x2 * wp)] = 1
    return batch


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _diff_to_rank0(flat):
    """max |flat - rank 0's flat| (0 on rank 0)."""
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0)
    return float((flat - ref).abs().max())


def main(work):
    torch.set_num_threads(2)
    from stmask_torch.config import get_config
    from stmask_torch.models import STMask
    from stmask_torch.parallel import (initialize_multihost, rank,
                                       replicate, shard_batch)
    from stmask_torch.train.train_step import build_train_step

    dev = initialize_multihost(device='cpu')
    cfg = reduce(get_config('STMask_plus_resnet50'))
    model = STMask(cfg)
    model.load_state_dict(torch.load(os.path.join(work, 'init.pt')))
    if rank() == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    step, init = build_train_step(cfg, model, device=dev)
    state = replicate(init())
    params = list(model.parameters())
    prev = _flat(params)
    out = {'metrics': [], 'grads': [], 'params': [], 'grad_diff': [],
           'param_diff': [_diff_to_rank0(prev)], 'unchanged': []}
    batches = torch.load(os.path.join(work, 'batches.pt'),
                         weights_only=False)
    for i, b in enumerate(batches):
        local = shard_batch({k: torch.from_numpy(v)
                             for k, v in b.items()}, dev)
        state, metrics = step(state, local)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        new = _flat(params)
        out['grad_diff'].append(_diff_to_rank0(_flat([p.grad
                                                      for p in params])))
        out['param_diff'].append(_diff_to_rank0(new))
        out['unchanged'].append(torch.equal(new, prev))
        prev = new
        if rank() == 0 and i < KEEP:
            out['grads'].append({k: p.grad.clone() for k, p in
                                 model.named_parameters()})
            out['params'].append({k: p.detach().clone() for k, p in
                                  model.named_parameters()})
            if i == 0:
                out['momentum'] = [m.clone() for m in state.momentum]
    out['count'], out['step'] = int(state.count), state.step
    torch.save(out, os.path.join(work, f'rank{rank()}.pt'))
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1])
