"""Where a kernel's time goes, on the card: builds with parts left out.

A kernel source that takes part in a split reads a preprocessor macro
whose bits leave parts of the measured entry's work out (measurement
builds only: the library's own build leaves it 0).  ``build_variants``
builds one library per part at once (one nvcc each); ``split`` times the
wrapper at the sites it is given while each variant stands in for the
wrapper's entry, beside the library's own build ('whole').  A part's share
is the time the whole build takes beyond the build without it; the parts
overlap, so the shares need not add up to the whole.

The kernels that take part:

- ``CONV``: the bf16 fused deformable conv (``csrc/deform_conv.cu``,
  ``STMASK_DCONV_DROP``): bit 1 the products, 2 the gather, 4 the output
  stores, 8 the cluster's reduction.
- ``COL2IM``: K4's bf16 entries (``csrc/deform_col2im.cu``,
  ``STMASK_COL2IM_DROP``): bit 1 the copies into shared memory, 2 the
  dot-product pass (d_offset and d_mask), 4 the dx pass, 8 the dx
  reductions into device memory, 16 the zeroing and rounding of dx's fp32
  sums.
- ``CORR``: K1's bf16 entry (``csrc/correlation.cu``, ``STMASK_CORR_DROP``):
  bit 1 the copies into shared memory, 2 the products, 4 the butterfly
  over the channel slices, 8 the output stores.
- ``CORR_BWD``: K3's bf16 entry (``csrc/correlation_bwd.cu``,
  ``STMASK_CORRBWD_DROP``): bit 1 the source rows' staging, 2 the
  prologue's G formation, 4 the FMAs, 8 the output stores.
- ``EXACT_BWD`` and ``EXACT_BWD_F32``: K5's bf16 and fp32 entries (one
  macro for every entry of ``csrc/deform_exact_bwd.cu``,
  ``STMASK_EXACTBWD_DROP``): bit 1 the corner reads of x and the dot
  products S, 2 the dx reductions into device memory, 4 the reads of dcols,
  8 (bf16 only) the zeroing and rounding of dx's fp32 sums, 16 (the fast
  route's) the footprint pass (the inside items' dx and dot products).
- ``GREEDY`` and ``GREEDY_BOXES``: B5's two entries, one route each
  (``csrc/greedy_nms.cu``, ``STMASK_NMS_DROP``): bit 1 the suppression rows
  (in the boxes entry with their IoUs), 2 the scan, 4 (boxes entry) the
  reads of the boxes and their indices.

A kernel with a fast route and a general one (the design every call took
before the fast route) names the wrapper's route predicate, and ``split``
measures the general route by having the predicate say no; a kernel with
one route names none and is split on the route 'general'.
``chip_smoke.py`` prints the splits once a run (``CONV`` at 8 frames of the
flagship's 7 DCN sites and FCB's 48x80 3x5 site, ``COL2IM`` likewise in
training, ``CORR`` at one lane-frame of the eval CLI, B5's at one and at 8
frames' classes, ``CORR_BWD`` at the training shape [4, 24, 40, 256],
K5's two at the training sites of ``COL2IM`` with N(0, 1.5) offsets):

    build_variants(COL2IM)
    rows = split(COL2IM, K4, sites, call, time_ms, 'fast')
    print_split(COL2IM, 'fast', rows, smi, frames=8)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from .build import CudaKernel, build


@dataclass(frozen=True)
class Parts:
    """A kernel's split: the library, its drop macro, the parts ((bit,
    label), ...), the wrapper's entry that a variant stands in for and the
    wrapper's route predicate (None: the kernel has one route)."""
    library: str
    macro: str
    parts: Tuple[Tuple[int, str], ...]
    entry: str
    predicate: Optional[str] = None


CONV = Parts('deform_conv', 'STMASK_DCONV_DROP',
             ((1, 'no products'), (2, 'no gather'), (4, 'no output stores'),
              (8, 'no cluster reduction')),
             'KERNEL_BF16', 'conv_fast')
COL2IM = Parts('deform_col2im', 'STMASK_COL2IM_DROP',
               ((1, 'no copies'), (2, 'no dot products'), (4, 'no dx pass'),
                (8, 'no dx reductions'), (16, 'no dx zeroing and rounding')),
               'KERNEL_BF16', 'col2im_fast')
CORR = Parts('correlation', 'STMASK_CORR_DROP',
             ((1, 'no copies'), (2, 'no products'), (4, 'no butterfly'),
              (8, 'no output stores')),
             'KERNEL_BF16', 'corr_fast')
CORR_BWD = Parts('correlation_bwd', 'STMASK_CORRBWD_DROP',
                 ((1, 'no source-row staging'), (2, 'no G formation'),
                  (4, 'no FMAs'), (8, 'no output stores')),
                 'KERNEL_BF16', 'corr_bwd_fast')
_EXACT_PARTS = ((1, 'no x reads or dot products'), (2, 'no dx reductions'),
                (4, 'no dcols reads'), (16, 'no footprint pass (fast route)'))
EXACT_BWD = Parts('deform_exact_bwd', 'STMASK_EXACTBWD_DROP',
                  _EXACT_PARTS + ((8, 'no dx zeroing and rounding'),),
                  'KERNEL_BF16', 'exact_bwd_fast')
EXACT_BWD_F32 = Parts('deform_exact_bwd', 'STMASK_EXACTBWD_DROP',
                      _EXACT_PARTS, 'KERNEL', 'exact_bwd_fast')
GREEDY = Parts('greedy_nms', 'STMASK_NMS_DROP',
               ((1, 'no suppression rows'), (2, 'no scan')), 'KERNEL')
GREEDY_BOXES = Parts('greedy_nms', 'STMASK_NMS_DROP',
                     ((1, 'no IoUs or suppression rows'), (2, 'no scan'),
                      (4, 'no box reads')), 'KERNEL_BOXES')


def _defines(spec: Parts, bits: int) -> tuple:
    return (f'{spec.macro}={bits}',) if bits else ()


def labels(spec: Parts) -> list:
    return ['whole'] + [label for _, label in spec.parts]


def build_variants(spec: Parts) -> float:
    """Build the library and every variant of ``spec`` at once (one nvcc
    each); returns the wall seconds."""
    import time
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(spec.parts) + 1) as pool:
        list(pool.map(lambda b: build([spec.library], _defines(spec, b)),
                      [0] + [bits for bits, _ in spec.parts]))
    return time.perf_counter() - t0


def split(spec: Parts, module, sites: Sequence, call: Callable,
          time_ms: Callable, route: str) -> dict:
    """{site: {label: device ms}} of the library and each variant of
    ``spec`` on ``route`` ('fast' or 'general').  ``sites`` holds (label,
    arguments of ``call``), which calls the wrapper in ``module`` whose
    entry ``spec.entry`` the variants stand in for (on the general route
    with ``spec.predicate``, if any, saying no); ``time_ms(fn)`` gives the
    device ms of one call of ``fn``.  A kernel without a predicate has
    only the general route."""
    if spec.predicate is None and route != 'general':
        raise ValueError(f'{spec.library}: one route, the general one; '
                         f'asked for {route!r}')
    own = getattr(module, spec.entry)
    fast = getattr(module, spec.predicate) if spec.predicate else None
    kernels = {label: CudaKernel(spec.library, own.symbol, own.argtypes,
                                 _defines(spec, bits))
               for bits, label in ((0, 'whole'),) + spec.parts}
    rows = {}
    try:
        if route == 'general' and spec.predicate:
            setattr(module, spec.predicate, lambda *a: False)
        for site, args in sites:
            rows[site] = {}
            for label, kern in kernels.items():
                setattr(module, spec.entry, kern)
                rows[site][label] = time_ms(lambda: call(*args))
    finally:
        setattr(module, spec.entry, own)
        if spec.predicate:
            setattr(module, spec.predicate, fast)
    return rows


def print_split(spec: Parts, route: str, rows: dict, smi: str,
                frames) -> None:
    """One ``[split]`` line a site and one for their sum; ``frames`` (a
    count of frames, or words) says what a site holds."""
    names = labels(spec)
    what = f'{frames} frames' if isinstance(frames, int) else frames
    total = {label: sum(r[label] for r in rows.values()) for label in names}
    for site, r in list(rows.items()) + [('all sites summed', total)]:
        whole = r['whole']
        parts = '; '.join(f'{label} {r[label]:.5f} ms ({whole - r[label]:+.5f})'
                          for label in names[1:])
        print(f'[split] {spec.library} {route} route, {site}, {what}: '
              f'whole {whole:.5f} ms; {parts} ({smi})', flush=True)
