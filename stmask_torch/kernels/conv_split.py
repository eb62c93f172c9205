"""Where the bf16 fused deformable conv's time goes, on the card.

Builds ``csrc/deform_conv.cu`` again with parts of its bf16 kernels left
out (``STMASK_DCONV_DROP``: bit 1 the products, 2 the gather, 4 the output
stores, 8 the cluster's reduction) and times the bf16 entry of each build
at the sites it is given, beside the whole kernel.  A part's share is the
time the whole build takes beyond the build without it; the parts overlap,
so the shares need not add up to the whole.  The fast route is measured as
the wrapper launches it; the general route (the design every DCN site took
before the fast route) by handing the entry split 0, which names it.

``chip_smoke.py`` prints the split once a run at the flagship's 7 DCN
sites and FCB's 48x80 3x5 site, 8 frames each:

    build_variants()
    rows = split(sites, time_ms, 'fast')
    print_split('fast', rows, smi, frames=8)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from . import deform_conv as KD
from .build import CudaKernel, build

# (bits of STMASK_DCONV_DROP, label)
PARTS = ((0, 'whole'), (1, 'no products'), (2, 'no gather'),
         (4, 'no output stores'), (8, 'no cluster reduction'))


def _defines(bits: int) -> tuple:
    return (f'STMASK_DCONV_DROP={bits}',)


def build_variants() -> float:
    """Build every variant of PARTS at once (one nvcc each); returns the
    wall seconds."""
    import time
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(PARTS)) as pool:
        list(pool.map(lambda b: build(['deform_conv'], _defines(b[0])),
                      PARTS))
    return time.perf_counter() - t0


def split(sites: Sequence, time_ms: Callable, route: str) -> dict:
    """{site: {label: device ms}} of every variant of PARTS on ``route``
    ('fast' or 'general').  ``sites`` holds (label, arguments of
    ``deform_conv_cuda`` with bf16 offsets); ``time_ms(fn)`` gives the
    device ms of one call of ``fn``.  Each variant stands in for the bf16
    entry while it is timed."""
    own = KD.KERNEL_BF16
    kernels = {label: CudaKernel('deform_conv', own.symbol, own.argtypes,
                                 _defines(bits)) for bits, label in PARTS}
    rows = {}
    try:
        for site, args in sites:
            rows[site] = {}
            for label, kern in kernels.items():
                # split 0 names the general route
                KD.KERNEL_BF16 = kern if route == 'fast' else (
                    lambda *a, k=kern: k(*a[:-2], 0, a[-1]))
                rows[site][label] = time_ms(
                    lambda: KD.deform_conv_cuda(*args))
    finally:
        KD.KERNEL_BF16 = own
    return rows


def print_split(route: str, rows: dict, smi: str, frames: int) -> None:
    """One ``[split]`` line a site and one for their sum."""
    labels = [label for _, label in PARTS]
    total = {label: sum(r[label] for r in rows.values()) for label in labels}
    for site, r in list(rows.items()) + [('all sites summed', total)]:
        whole = r['whole']
        parts = '; '.join(f'{label} {r[label]:.5f} ms ({whole - r[label]:+.5f})'
                          for label in labels[1:])
        print(f'[split] {route} route, {site}, {frames} frames: whole '
              f'{whole:.5f} ms; {parts} ({smi})', flush=True)
