"""The ``stmask::`` custom ops (``stmask_torch.kernels``) on the CPU.

``torch.library.opcheck`` of each op at small shapes: the schema, the fake
implementation (shape and dtype without data), no hidden mutation and
autograd's registration.  The op on CPU tensors is the plain version bit
for bit, and so is each wrapper; a wrapper called where autograd records
still differentiates through the plain version, as before the ops."""

import numpy as np
import pytest
import torch

from stmask_torch.kernels import correlation, deform_conv, greedy_nms


def _corr_args(dtype):
    g = torch.Generator().manual_seed(0)
    x1 = torch.randn(1, 5, 6, 8, generator=g).to(dtype)
    x2 = torch.randn(1, 5, 6, 8, generator=g).to(dtype)
    return x1, x2


def _dcn_args(dtype, off_dtype, mask=True, stride=1):
    g = torch.Generator().manual_seed(1)
    b, h, w, cin, cout, kh, kw = 2, 6, 7, 4, 5, 3, 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(b, h, w, cin, generator=g).to(dtype)
    om = torch.randn(b, ho, wo, 3 * kh * kw, generator=g)
    offset = om[..., :2 * kh * kw].to(off_dtype)         # a strided view
    m = torch.sigmoid(om[..., 2 * kh * kw:]).to(dtype) if mask else None
    weight = torch.randn(cout, kh, kw, cin, generator=g).to(dtype)
    bias = torch.randn(cout, generator=g).to(dtype)
    return x, offset, weight, m, bias, stride, 1


def _nms_args(k=6):
    g = torch.Generator().manual_seed(2)
    iou = torch.rand(3, k, k, generator=g)
    valid = torch.rand(3, k, generator=g) > 0.2
    return iou, valid, 0.5


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', [True, False])
def test_opcheck_correlate(dtype, act):
    x1, x2 = _corr_args(dtype)
    torch.library.opcheck(torch.ops.stmask.correlate.default,
                          (x1, x2, 3, act))
    out = torch.ops.stmask.correlate(x1, x2, 3, act)
    assert torch.equal(out, correlation.correlate_reference(x1, x2, 3, act))
    assert torch.equal(out, correlation.correlate(x1, x2, 3, act))


@pytest.mark.parametrize('case', ['fp32', 'fp32_v1_s2', 'bf16',
                                  'bf16_f32off'])
def test_opcheck_deform_conv(case):
    dtype = torch.bfloat16 if case.startswith('bf16') else torch.float32
    off_dtype = torch.float32 if case != 'bf16' else torch.bfloat16
    args = _dcn_args(dtype, off_dtype, mask=case != 'fp32_v1_s2',
                     stride=2 if case == 'fp32_v1_s2' else 1)
    torch.library.opcheck(torch.ops.stmask.deform_conv.default, args)
    out = torch.ops.stmask.deform_conv(*args)
    assert out.shape == (2,) + args[1].shape[1:3] + (5,)
    assert torch.equal(out, deform_conv.deform_conv_reference(*args))
    assert torch.equal(out, deform_conv.deform_conv(*args))


@pytest.mark.parametrize('k', [1, 6])
def test_opcheck_greedy_nms(k):
    args = _nms_args(k)
    torch.library.opcheck(torch.ops.stmask.greedy_nms_keep.default, args)
    keep = torch.ops.stmask.greedy_nms_keep(*args)
    assert keep.dtype == torch.bool
    assert torch.equal(keep, greedy_nms.greedy_nms_mask_reference(*args))
    assert torch.equal(keep, greedy_nms.greedy_nms_keep(*args))


@pytest.mark.parametrize('k', [1, 6, 65])
def test_opcheck_greedy_nms_plus_one(k):
    """B5's boxes entry: boxes [P, 4], idx [G, K] into them, scale, thr."""
    g = torch.Generator().manual_seed(3)
    lo = torch.rand(40, 2, generator=g) * 0.7
    boxes = torch.cat([lo, lo + 0.05 + torch.rand(40, 2, generator=g) * 0.3],
                      -1)
    idx = torch.randint(0, 40, (3, k), generator=g)
    valid = torch.rand(3, k, generator=g) > 0.2
    args = (boxes, idx, valid, 640.0, 0.5)
    torch.library.opcheck(
        torch.ops.stmask.greedy_nms_plus_one_keep.default, args)
    keep = torch.ops.stmask.greedy_nms_plus_one_keep(*args)
    assert keep.dtype == torch.bool and keep.shape == (3, k)
    want = greedy_nms.greedy_nms_mask_reference(
        greedy_nms.plus_one_iou(boxes[idx] * 640.0), valid, 0.5)
    assert torch.equal(keep, want)
    assert torch.equal(keep, greedy_nms.greedy_nms_plus_one_keep(*args))


def test_wrappers_differentiate_through_the_plain_version():
    """With autograd recording, the wrappers skip the op (which has no
    autograd formula) and take the plain version: the gradient is the
    plain version's."""
    x, offset, weight, mask, bias, s, d = _dcn_args(torch.float32,
                                                    torch.float32)
    weight.requires_grad_(True)
    deform_conv.deform_conv(x, offset, weight, mask, bias, s, d).sum() \
        .backward()
    w2 = weight.detach().clone().requires_grad_(True)
    deform_conv.deform_conv_reference(x, offset, w2, mask, bias, s,
                                      d).sum().backward()
    assert torch.equal(weight.grad, w2.grad)
    x1, x2 = _corr_args(torch.float32)
    x1.requires_grad_(True)
    correlation.correlate(x1, x2, 3).sum().backward()
    assert x1.grad is not None and np.isfinite(x1.grad.numpy()).all()


def test_ops_trace_through_export():
    """``torch.export`` records each op as one node from its fake
    implementation; the exported program calls the op."""
    class M(torch.nn.Module):
        def forward(self, x1, x2, x, offset, weight, iou, valid):
            c = correlation.correlate(x1, x2, 3)
            y = deform_conv.deform_conv(x, offset, weight, None, None)
            k = greedy_nms.greedy_nms_keep(iou, valid, 0.5)
            return c, y, k

    x1, x2 = _corr_args(torch.float32)
    x, offset, weight, _, _, _, _ = _dcn_args(torch.float32, torch.float32)
    iou, valid, _ = _nms_args()
    args = (x1, x2, x, offset.contiguous(), weight, iou, valid)
    ep = torch.export.export(M(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    for op in ('stmask.correlate.default', 'stmask.deform_conv.default',
               'stmask.greedy_nms_keep.default'):
        assert targets.count(op) == 1, targets
    for got, want in zip(ep.module()(*args), M()(*args)):
        assert torch.equal(got, want)


def _bwd_args(op, dtype, mask=True):
    """Arguments of a training-backward op at small shapes: g or the
    column gradient, and the forward's inputs (offsets in the window)."""
    x, offset, weight, m, _, stride, dilation = _dcn_args(
        dtype, dtype, mask=mask)
    g = torch.Generator().manual_seed(3)
    offset = offset.clamp(-2, 2)
    b, ho, wo, _ = offset.shape
    cout, kh, kw, cin = weight.shape
    if op == 'deform_wgrad':
        gm = torch.randn(b * ho * wo, cout, generator=g).to(dtype)
        return gm, x, offset, m, kh, kw, stride, dilation
    dcols = torch.randn(b * ho * wo, kh * kw * cin, generator=g).to(dtype)
    args = (dcols, x, offset, m, kh, kw, stride, dilation)
    return args + (2,) if op == 'deform_col2im' else args


@pytest.mark.parametrize('case', [
    'correlation_bwd', 'correlation_bwd_out', 'correlation_bwd_bf16',
    'deform_wgrad', 'deform_wgrad_bf16', 'deform_col2im',
    'deform_col2im_v1', 'deform_exact_bwd', 'deform_exact_bwd_v1'])
def test_opcheck_backward_ops(case):
    """The training backward's ops (called with autograd off, as a backward
    runs): opcheck, and the op, the wrapper and the plain version agree bit
    for bit; a v1 call (no mask) gives no d_mask through the wrapper."""
    from stmask_torch.kernels import (correlation_bwd, deform_col2im,
                                      deform_exact_bwd, deform_wgrad)
    dtype = torch.bfloat16 if case.endswith('bf16') else torch.float32
    if case.startswith('correlation_bwd'):
        x1, x2 = _corr_args(dtype)
        out = correlation.correlate_reference(x1, x2, 3, True)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
        args = (g, x1, x2, 3, out if case != 'correlation_bwd' else None)
        name, mod = 'correlation_bwd', correlation_bwd
        ref = correlation_bwd.correlation_bwd_reference
    else:
        name = case.replace('_bf16', '').replace('_v1', '')
        mod = {'deform_wgrad': deform_wgrad, 'deform_col2im': deform_col2im,
               'deform_exact_bwd': deform_exact_bwd}[name]
        args = _bwd_args(name, dtype, mask=not case.endswith('_v1'))
        ref = getattr(mod, f'{name}_reference')
    op = getattr(torch.ops.stmask, name)
    torch.library.opcheck(op.default, args)
    got, want, wrapped = op(*args), ref(*args), getattr(mod, name)(*args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    wrapped = wrapped if isinstance(wrapped, tuple) else (wrapped,)
    for a, b, c in zip(got, want, wrapped):
        if b is None:
            assert c is None and a.numel() == 0
            continue
        assert torch.equal(a, b) and torch.equal(c, b)
