"""Weight gradient of the modulated deformable conv with the gather fused
into the GEMM: CUDA kernel ``deform_wgrad`` (fp32 and bf16 entries) and its
plain versions.

Replaces, in the training path's DCN backward, K2 (``deform_im2col``) and
the matmul ``g.t() @ cols`` after it; in the JAX package, the transpose of
``jnp.dot(vals, weight.reshape(k*cin, cout))`` in
``stmask_tpu/ops/deform_conv.py::deform_conv2d_window`` (``:347``), which
XLA differentiates.  ``deform_wgrad`` calls the custom op
``stmask::deform_wgrad``, which dispatches on the device: CPU tensors take
``deform_wgrad_reference``, CUDA tensors take the kernel in
``csrc/deform_wgrad.cu`` or raise.

``wgrad_plan`` chooses how the kernel cuts a call (its tiles and the
cluster that splits the sites); the kernel takes the split as it is.

The bf16 entries (bf16 ``g``, ``x`` and mask; the offsets bf16, or fp32
beside bf16 data, as the forward's entries take them) gather the columns
as the bf16 forward does (``deform_conv.deform_cols_bf16``: the JAX
package's bf16 values, the modulation applied after the rounded corner
sum), sum their exact products in fp32 and round d_w to bf16 once, the type
of the JAX package's weight cotangent before its cast back to the fp32
master.  Both types take the kernel's fast path under the same conditions
(``wgrad_fast``: Cin a multiple of 32, Cout of 128, x and g 16-byte
aligned; every DCN site of the flagship and of FCB).  In bf16 it runs one
bf16 ``wgmma`` per 16 sites on g^T and the gathered columns, both kept in
bf16 in shared memory in the 128-byte swizzle; other shapes take the
general path (one sample an element, the 128-channel tile).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .build import CudaKernel, check_cuda, records_grad
from .deform_conv import check_types, deform_cols_bf16
from .deform_im2col import deform_im2col_reference

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
KERNEL = CudaKernel('deform_wgrad', 'stmask_deform_wgrad', _ARGTYPES)
KERNEL_BF16 = CudaKernel('deform_wgrad', 'stmask_deform_wgrad_bf16',
                         _ARGTYPES)
KERNEL_BF16_F32OFF = CudaKernel('deform_wgrad',
                                'stmask_deform_wgrad_bf16_f32off', _ARGTYPES)

# the kernel's tiles (csrc/deform_wgrad.cu): TM output channels, 64 a
# warpgroup (128 with 256 threads, two blocks an SM; 256 with 512 threads,
# one block an SM) x TN columns, BS sites a chunk.  Shared memory: two
# stages each of g and of the gathered columns (fp32: hi and lo planes, 68
# floats per 8 columns and 8 sites; the bf16 fast path: 128 bytes a site's
# 64 values, behind 1024 bytes of slack that align the swizzle), the staged
# corner runs (bf16: two buffers), three chunks of the corner table (32
# bytes an entry), the filling threads' cursors and the count of filling
# warps
TN, BS = 64, 32
ENTRIES = BS * (TN // 32)
ROW16 = 2 * TN                # bytes of a site's TN bf16 values
SMS = 132                     # the H100's SMs
WAVES = 4                     # blocks an SM the plan aims for
MAX_SPLIT = 16                # blocks of a cluster (non-portable size)


def smem_bytes(tm: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one block: the fp32 layout (also the bf16
    general path's), or the bf16 fast path's when ``bf16``."""
    tables = 3 * ENTRIES * 32 + ENTRIES * 16 + 16
    if bf16:
        return (1024 + 2 * BS * ROW16 + 2 * (tm // 64) * BS * ROW16
                + 2 * BS * 4 * TN * 2 + tables)
    return (4 * (2 * BS * (tm + 8) + 2 * 2 * (BS // 8) * (TN // 8) * 68
                 + BS * 4 * TN) + tables)


def wgrad_fast(cin: int, cout: int, x_ptr: int, g_ptr: int) -> bool:
    """Whether a call takes the kernel's fast path (fp32 and bf16 alike):
    Cin a multiple of 32, Cout of 128, x and g 16-byte aligned."""
    return (cin % 32 == 0 and cout % 128 == 0 and x_ptr % 16 == 0
            and g_ptr % 16 == 0)


@dataclass(frozen=True)
class WgradPlan:
    """How the kernel cuts one call: output tiles of ``tm`` x TN, each
    summed over the sites by the ``split`` blocks of one cluster,
    ``blocks`` in all, each with ``smem`` bytes of shared memory."""
    tm: int
    split: int
    blocks: int
    smem: int


def wgrad_plan(m: int, cout: int, ktot: int, fast: bool = True,
               bf16: bool = False) -> WgradPlan:
    """The tile height: 256 output channels on the fast path (Cin a
    multiple of 32, Cout of the tile height, aligned pointers) when Cout is
    a multiple of 256, so that each gathered column serves twice the
    channels (at the flagship's layer2 and layer3 sites it is the faster
    tile: ``chip_smoke.py`` times both); else 128.
    Then split the ``m`` sites over the fewest blocks of a cluster (a power
    of two, up to 16 with two blocks an SM and 8 with one) that give each
    SM ``WAVES`` blocks, keeping at least 8 chunks a block.  ``bf16``: the
    bf16 entries (their fast path's shared memory)."""
    tm = 256 if fast and cout % 256 == 0 else 128
    tiles = -(-cout // tm) * -(-ktot // TN)
    chunks = -(-m // BS)
    split = 1
    while (split < MAX_SPLIT * 128 // tm and tiles * split < WAVES * SMS
           and chunks >= 16 * split):
        split *= 2
    return WgradPlan(tm, split, tiles * split, smem_bytes(tm, bf16 and fast))


def deform_wgrad_reference(g: torch.Tensor, x: torch.Tensor,
                           offset: torch.Tensor,
                           mask: Optional[torch.Tensor], kh: int, kw: int,
                           stride: int = 1, dilation: int = 1
                           ) -> torch.Tensor:
    """Plain PyTorch weight gradient: ``g.t() @ cols``.

    Args:
      g: [B*Ho*Wo, Cout], the output's gradient; x: [B, H, W, Cin];
        offset: [B, Ho, Wo, 2K] with (dy, dx) interleaved per tap, taps
        row-major (K = kh*kw); mask: [B, Ho, Wo, K] (already sigmoid-ed)
        or None.  All fp32, or g, x and mask bf16 with bf16 or fp32
        offsets.
    Returns:
      d_w [Cout, kh, kw, Cin] in x's type: in bf16 the columns of
      ``deform_cols_bf16``, the product summed in fp32 and rounded.
    """
    if x.dtype == torch.bfloat16:
        cols = deform_cols_bf16(x, offset, mask, kh, kw, stride, dilation)
        return (g.float().t() @ cols).to(torch.bfloat16).reshape(
            g.shape[1], kh, kw, x.shape[3])
    cols = deform_im2col_reference(x, offset, mask, kh, kw, stride,
                                   dilation)
    return (g.t() @ cols).reshape(g.shape[1], kh, kw, x.shape[3])


def deform_wgrad_cuda(g: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                      mask: Optional[torch.Tensor], kh: int, kw: int,
                      stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """The kernel on contiguous CUDA tensors (shapes and types as above),
    cut as ``wgrad_plan`` says, on the fast path where ``wgrad_fast``
    holds.  In bf16 that path keeps g and the gathered columns in bf16 in
    shared memory (each site's 64 values one 128-byte row, 128-byte
    swizzle) and runs one ``wgmma.m64n64k16`` bf16 product per 16 sites,
    summed in fp32 and rounded once; the gather (a corner table per (site,
    tap), cp.async corner runs, the combine overlapped with the products)
    is the fp32 fast path's.  Other shapes take the general path: one
    sample an element, the 128-channel tile."""
    dt = check_types('deform_wgrad_cuda', x, offset)
    check_cuda('deform_wgrad_cuda', *(t for t in (g, x, mask)
                                      if t is not None), dtype=dt)
    check_cuda('deform_wgrad_cuda', offset, dtype=offset.dtype)
    b, h, w, cin = x.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_wgrad_cuda: offset {tuple(offset.shape)} '
                         f'is not [{b}, Ho, Wo, {2 * k}]')
    _, ho, wo, _ = offset.shape
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_wgrad_cuda: mask {tuple(mask.shape)} is '
                         f'not {(b, ho, wo, k)}')
    if g.dim() != 2 or g.shape[0] != b * ho * wo:
        raise ValueError(f'deform_wgrad_cuda: g {tuple(g.shape)} is not '
                         f'[{b * ho * wo}, Cout]')
    cout = g.shape[1]
    fast = wgrad_fast(cin, cout, x.data_ptr(), g.data_ptr())
    plan = wgrad_plan(b * ho * wo, cout, k * cin, fast,
                      bf16=dt == torch.bfloat16)
    dw = torch.empty((cout, kh, kw, cin), dtype=dt, device=x.device)
    kernel = (KERNEL if dt == torch.float32 else
              KERNEL_BF16 if offset.dtype == dt else KERNEL_BF16_F32OFF)
    kernel(g.data_ptr(), x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), dw.data_ptr(),
           b, h, w, cin, ho, wo, cout, kh, kw, stride, dilation, plan.tm,
           plan.split,
           torch.cuda.current_stream(x.device).cuda_stream)
    return dw


@torch.library.custom_op('stmask::deform_wgrad', mutates_args=(),
                         device_types='cuda')
def _deform_wgrad_op(g: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                     mask: Optional[torch.Tensor], kh: int, kw: int,
                     stride: int, dilation: int) -> torch.Tensor:
    return deform_wgrad_cuda(g, x, offset, mask, kh, kw, stride, dilation)


@_deform_wgrad_op.register_kernel('cpu')
def _(g, x, offset, mask, kh, kw, stride, dilation):
    return deform_wgrad_reference(g, x, offset, mask, kh, kw, stride,
                                  dilation)


@_deform_wgrad_op.register_fake
def _(g, x, offset, mask, kh, kw, stride, dilation):
    return x.new_empty((g.shape[1], kh, kw, x.shape[3]))


def deform_wgrad(g: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                 mask: Optional[torch.Tensor], kh: int, kw: int,
                 stride: int = 1, dilation: int = 1) -> torch.Tensor:
    if records_grad(g, x, offset, mask):
        if x.device.type == 'cpu':
            return deform_wgrad_reference(g, x, offset, mask, kh, kw, stride,
                                          dilation)
        return deform_wgrad_cuda(g, x, offset, mask, kh, kw, stride,
                                 dilation)
    return torch.ops.stmask.deform_wgrad(g, x, offset, mask, kh, kw, stride,
                                         dilation)
