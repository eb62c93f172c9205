"""Bring one dispatch's kept outputs to the host (port of ``eval.py:188-234``,
``_fetch_kept`` and ``_compact_frame``).

A dispatch's ``FrameOutput`` holds the whole track bank, masks included
([..., T, Hp, Wp]: 63 MB for a chunk of 4 x 8 lanes at 360x640).  Only the
small fields and the kept rows' masks leave the card:

1. ``KeptFetch(outs)``, called right after the dispatch is enqueued, queues
   the copies of the small fields into pinned host buffers (non-blocking,
   on the compute stream, behind the dispatch) and records an event;
2. ``KeptFetch.result()`` waits for that event only, finds the kept rows on
   the host, and gathers their masks on a side stream that waits on the
   same event, into a pinned buffer.  A later dispatch already queued on
   the compute stream keeps running meanwhile: the fetch of chunk N
   overlaps the compute of chunk N+1.

On the CPU both steps are plain indexing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .tracker import FrameOutput

_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a pinned host buffer without blocking (CUDA), or
    ``t`` itself (CPU)."""
    if t.device.type != 'cuda':
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class KeptFetch:
    """The host copy of one dispatch's outputs, started when it is made."""

    def __init__(self, outs: FrameOutput):
        self.outs = outs
        self.small = {f: _host(getattr(outs, f)) for f in outs._fields
                      if f != 'mask'}
        self.ready = None
        if outs.keep.device.type == 'cuda':
            self.ready = torch.cuda.Event()
            self.ready.record()

    def result(self) -> Tuple[Dict[str, np.ndarray], Tuple[np.ndarray, ...],
                              np.ndarray]:
        """(small: field -> array, keep_idx: index arrays of the kept rows,
        kept_masks: float32 [N, Hp, Wp] in keep_idx order)."""
        if self.ready is not None:
            self.ready.synchronize()
        small = {f: t.numpy() for f, t in self.small.items()}
        keep_idx = np.nonzero(small['keep'])
        mask = self.outs.mask
        if keep_idx[0].size == 0:
            return small, keep_idx, np.zeros((0,) + tuple(mask.shape[-2:]),
                                              np.float32)
        if mask.device.type != 'cuda':
            idx = tuple(torch.from_numpy(i) for i in keep_idx)
            return small, keep_idx, mask[idx].float().numpy()
        side = _SIDE.setdefault(mask.device, torch.cuda.Stream(mask.device))
        side.wait_event(self.ready)
        with torch.cuda.stream(side):
            idx = tuple(torch.from_numpy(i).to(mask.device, non_blocking=True)
                        for i in keep_idx)
            kept = _host(mask[idx].float())
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return small, keep_idx, kept.numpy()


def fetch_kept(outs: FrameOutput):
    """``KeptFetch(outs).result()``: the small fields, the kept rows'
    indices and their masks on the host."""
    return KeptFetch(outs).result()


def compact_frame(small: Dict[str, np.ndarray], keep_idx, kept_masks,
                  lead: Tuple[int, ...] = ()) -> FrameOutput:
    """One frame's kept rows as a ``FrameOutput`` of CPU tensors with keep
    all True, for ``postprocess_frame``.  ``lead`` selects the (step, lane)
    of a batched dispatch; () a single frame."""
    if keep_idx[0].size:
        sel = np.ones(keep_idx[0].shape, bool)
        for axis, want in enumerate(lead):
            sel &= keep_idx[axis] == want
    else:
        sel = np.zeros(0, bool)
    slots = keep_idx[-1][sel]

    def pick(f):
        return torch.from_numpy(np.ascontiguousarray(small[f][lead][slots]))

    return FrameOutput(box=pick('box'), score=pick('score'), cls=pick('cls'),
                       mask=torch.from_numpy(kept_masks[sel]),
                       obj_id=pick('obj_id'),
                       keep=torch.ones(len(slots), dtype=torch.bool))
