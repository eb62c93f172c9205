"""K3 bf16's fast route, on the CPU.

``corr_bwd_fast`` says which bf16 calls of K3 (the correlation's backward)
take the fast route (bf16 source rows staged by 16-byte ``cp.async``): C a
multiple of 8 and x1, x2, dx1 and dx2 16-byte aligned.  These tests hold
the predicate on calls that must take it and calls that must not, the
wrapper (its CUDA checks and launches replaced by recorders) to the route
it hands the bf16 entry, and the split spec to its parts."""

import pytest
import torch

from stmask_torch.kernels import correlation_bwd as K3
from stmask_torch.kernels import split as KS
from stmask_torch.kernels.correlation_bwd import corr_bwd_fast

ALIGNED = 4096               # a 16-byte aligned byte address


@pytest.mark.parametrize('case', [
    dict(c=256), dict(c=8), dict(c=40), dict(c=64), dict(c=96),
    dict(c=264), dict(c=5, on=False), dict(c=12, on=False),
    dict(c=100, on=False), dict(x1=2, on=False), dict(x2=8, on=False),
    dict(dx1=4, on=False), dict(dx2=14, on=False),
    dict(x1=16, x2=32, dx1=48, dx2=64)], ids=str)
def test_route_predicate(case):
    """On the route: every training site (C 256) and any C that is a
    multiple of 8, with every map 16-byte aligned.  Off it: C 5, 12, 100,
    or a map (x1, x2, dx1 or dx2) that starts off a 16-byte boundary."""
    a = dict(c=256, x1=0, x2=0, dx1=0, dx2=0, on=True)
    a.update(case)
    assert corr_bwd_fast(a['c'], *(ALIGNED + a[k] for k in (
        'x1', 'x2', 'dx1', 'dx2'))) == a['on']


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize('shape,off', [((4, 24, 40, 256), 0),
                                       ((2, 7, 9, 96), 0),
                                       ((1, 6, 5, 12), 0),
                                       ((1, 5, 7, 40), 0),
                                       ((4, 24, 40, 256), 1)], ids=str)
def test_wrapper_routes_calls(monkeypatch, shape, off):
    """correlation_bwd_cuda hands the bf16 entry the route corr_bwd_fast
    decides from x1, x2 and the dx1, dx2 it allocates (1 fast, 0 general)
    as its 13th argument; fp32 calls keep the fp32 entry and its arguments
    (no route).  Checked on the CPU with the CUDA checks and the launches
    replaced by recorders."""
    calls = []
    n_args = {n: len(getattr(K3, n).argtypes) for n in ('KERNEL',
                                                        'KERNEL_BF16')}
    assert n_args == {'KERNEL': 13, 'KERNEL_BF16': 14}
    monkeypatch.setattr(K3, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16'):
        monkeypatch.setattr(K3, name, lambda *a, _n=name: calls.append(
            (_n, a)))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    n = torch.Size(shape).numel()
    buf = torch.zeros(2 * n + 16, dtype=torch.bfloat16)
    x1 = buf[off:off + n].view(shape)
    x2 = buf[n + 8:2 * n + 8].view(shape)
    g = torch.zeros(shape[:3] + (121,))
    dx1, dx2 = K3.correlation_bwd_cuda(g, x1, x2, 11, out=g)
    assert dx1.shape == dx2.shape == shape and dx1.dtype == torch.bfloat16
    name, args = calls.pop()
    assert name == 'KERNEL_BF16' and len(args) == n_args[name]
    ptrs = (x1.data_ptr(), x2.data_ptr(), dx1.data_ptr(), dx2.data_ptr())
    assert args[:6] == (g.data_ptr(), g.data_ptr()) + ptrs
    assert args[6:12] == (121,) + tuple(shape) + (11,)
    fast = corr_bwd_fast(shape[-1], *ptrs)
    assert fast == (shape[-1] % 8 == 0 and off == 0)
    assert args[12] == int(fast)
    K3.correlation_bwd_cuda(g, x1.float(), x2.float(), 11)
    name, args = calls.pop()
    assert name == 'KERNEL' and len(args) == n_args[name]
    assert args[1] is None and args[6:12] == (121,) + tuple(shape) + (11,)


def test_corr_bwd_spec_parts():
    """K3 bf16's split: the source rows' staging, the prologue's G
    formation, the FMAs and the output stores, behind the route predicate
    corr_bwd_fast."""
    assert KS.CORR_BWD.parts == ((1, 'no source-row staging'),
                                 (2, 'no G formation'), (4, 'no FMAs'),
                                 (8, 'no output stores'))
    assert (KS.CORR_BWD.library, KS.CORR_BWD.macro, KS.CORR_BWD.entry,
            KS.CORR_BWD.predicate) == ('correlation_bwd',
                                       'STMASK_CORRBWD_DROP', 'KERNEL_BF16',
                                       'corr_bwd_fast')
