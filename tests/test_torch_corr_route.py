"""K1's bf16 fast route and the kernels' splits, on the CPU.

``corr_fast`` says which bf16 calls take K1's fast route (packed bf16x2
products, 16-byte reads of 8 channels): C a multiple of 8 and 16-byte
aligned x1 and x2.  These tests hold the predicate on shapes that must take
it and shapes that must not, the wrapper (its CUDA checks and launches
replaced by recorders) to the route it hands the bf16 entry, and the split
specs of ``kernels/split.py`` to the drop bits their sources read."""

import re

import pytest
import torch

from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import split as KS
from stmask_torch.kernels.build import CSRC
from stmask_torch.kernels.correlation import corr_fast

ALIGNED = 4096               # a 16-byte aligned byte address


@pytest.mark.parametrize('case', [
    dict(c=256), dict(c=8), dict(c=16), dict(c=264), dict(c=40),
    dict(c=96), dict(c=5, on=False), dict(c=12, on=False),
    dict(c=100, on=False), dict(x1_off=2, on=False),
    dict(x2_off=8, on=False), dict(x1_off=16, x2_off=32)], ids=str)
def test_route_predicate(case):
    """On the route: every TF site of the port (C 256) and any C that is a
    multiple of 8, both maps 16-byte aligned.  Off it: C 5, 12, 100, or a
    map that starts one or four elements into its buffer."""
    a = dict(c=256, x1_off=0, x2_off=0, on=True)
    a.update(case)
    assert corr_fast(a['c'], ALIGNED + a['x1_off'],
                     ALIGNED + a['x2_off']) == a['on']


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize('shape,off', [((1, 24, 40, 256), 0),
                                       ((2, 7, 9, 96), 0),
                                       ((1, 3, 2, 5), 0),
                                       ((1, 5, 70, 40), 0),
                                       ((1, 24, 40, 256), 1)], ids=str)
def test_wrapper_routes_calls(monkeypatch, shape, off):
    """correlate_cuda hands the bf16 entry the route corr_fast decides (1
    fast, 0 general) as its 10th argument; fp32 calls keep the fp32 entry
    and its arguments (no route).  Checked on the CPU with the CUDA checks
    and the launches replaced by recorders."""
    calls = []
    n_args = {n: len(getattr(K1, n).argtypes) for n in ('KERNEL',
                                                        'KERNEL_BF16')}
    assert n_args == {'KERNEL': 10, 'KERNEL_BF16': 11}
    monkeypatch.setattr(K1, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16'):
        monkeypatch.setattr(K1, name, lambda *a, _n=name: calls.append(
            (_n, a)))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    n = torch.Size(shape).numel()
    buf = torch.zeros(2 * n + 16, dtype=torch.bfloat16)
    x1 = buf[off:off + n].view(shape)
    x2 = buf[n + 8:2 * n + 8].view(shape)
    out = K1.correlate_cuda(x1, x2, 11)
    assert out.shape == shape[:3] + (121,) and out.dtype == torch.float32
    name, args = calls.pop()
    assert name == 'KERNEL_BF16' and len(args) == n_args[name]
    fast = corr_fast(shape[-1], x1.data_ptr(), x2.data_ptr())
    assert fast == (shape[-1] % 8 == 0 and off == 0)
    assert args[9] == int(fast)
    assert args[:3] == (x1.data_ptr(), x2.data_ptr(), out.data_ptr())
    assert args[3:9] == tuple(shape) + (11, 1)
    K1.correlate_cuda(x1.float(), x2.float(), 11, False)
    name, args = calls.pop()
    assert name == 'KERNEL' and len(args) == n_args[name]
    assert args[3:9] == tuple(shape) + (11, 0)


@pytest.mark.parametrize('spec', [KS.CONV, KS.COL2IM, KS.CORR, KS.CORR_BWD,
                                  KS.GREEDY, KS.GREEDY_BOXES],
                         ids=lambda s: f'{s.library}.{s.entry}')
def test_split_specs(spec):
    """Each spec's labels are 'whole' and its parts', its bits distinct
    powers of two, its source reads its macro, and the module has its
    entry and route predicate (None for a kernel with one route)."""
    import importlib
    assert KS.labels(spec) == ['whole'] + [lb for _, lb in spec.parts]
    bits = [b for b, _ in spec.parts]
    assert len(set(bits)) == len(bits)
    assert all(b & (b - 1) == 0 and b > 0 for b in bits)
    src = (CSRC / f'{spec.library}.cu').read_text()
    assert re.search(rf'#define {spec.macro} 0', src)
    mod = importlib.import_module(f'stmask_torch.kernels.{spec.library}')
    assert getattr(mod, spec.entry).library == spec.library
    assert spec.predicate is None or callable(getattr(mod, spec.predicate))


def test_corr_spec_parts():
    """K1 bf16's split: the copies, the products, the butterfly and the
    output stores, behind the route predicate corr_fast."""
    assert KS.CORR.parts == ((1, 'no copies'), (2, 'no products'),
                             (4, 'no butterfly'), (8, 'no output stores'))
    assert (KS.CORR.library, KS.CORR.macro, KS.CORR.entry,
            KS.CORR.predicate) == ('correlation', 'STMASK_CORR_DROP',
                                   'KERNEL_BF16', 'corr_fast')


def test_split_of_a_kernel_with_one_route(monkeypatch):
    """A spec without a predicate is split on the general route, its entry
    swapped for each variant and put back; a fast route is refused."""
    from stmask_torch.kernels import greedy_nms as KG
    seen = []
    own = KG.KERNEL
    rows = KS.split(KS.GREEDY, KG, [('s', (1,))],
                    lambda x: seen.append(KG.KERNEL.defines),
                    lambda fn: fn() or 1.0, 'general')
    assert rows == {'s': {label: 1.0 for label in KS.labels(KS.GREEDY)}}
    assert seen == [(), ('STMASK_NMS_DROP=1',), ('STMASK_NMS_DROP=2',)]
    assert KG.KERNEL is own
    with pytest.raises(ValueError, match='one route'):
        KS.split(KS.GREEDY, KG, [], None, None, 'fast')
