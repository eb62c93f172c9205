"""Backward of the exact (unclamped) deformable gather: CUDA kernel K5 (fp32
and bf16 entries) and its plain version.

Replaces the autodiff of ``stmask_tpu/ops/deform_conv.py::deform_conv2d``'s
gather (``deform_conv.py:31-89``) through ``ops/sampling.py::
bilinear_sample_block`` (``sampling.py:48-85``): the path the JAX package
trains its DCN sites and FCB through at window radius 0.
``deform_exact_bwd`` calls the custom op ``stmask::deform_exact_bwd``,
which dispatches on the device: CPU tensors take
``deform_exact_bwd_reference``, CUDA tensors take the kernel in
``csrc/deform_exact_bwd.cu`` or raise.

The forward samples each (site, tap) at p = (py, px) from a block of 2 x 2
pixels (1 wide along a 1-pixel dimension) whose origin is clipped to the
image, ``y0 = clip(floor(py), 0, H - min(2, H))``, with the weights
``clip(1 - |py - (y0 + r)|, 0, 1)`` (likewise in x).  JAX differentiates
those weights as written: ``|d|``'s derivative is 1 at 0, and
``jnp.clip``'s ``maximum`` and ``minimum`` each give half the gradient to
a tie.  So a weight of 0 with ``|d| == 1`` passes -0.5 * sign(d), and a
weight of 1 (``1 - |d|`` rounds to 1) passes -0.5, or +0.5 where d < 0.
Every sample at an integer row or column sits on such ties, which decide
the whole offset gradient where the offset predictors start at zero.  At
the image's last row the clipped origin pairs that row with the one above
it (d/dy = -0.5 * (x[H-2] + x[H-1]) at y = H - 1), and one row past it a
sample still has the gradient -0.5 * x[H-1].  ``torch.clamp`` and
``torch.abs`` have other subgradients, so the plain version writes these
rules out instead of differentiating a transcription.

The bf16 entries (bf16 ``dcols``, ``x`` and mask; the offsets bf16, or fp32
beside bf16 data) compute in fp32 from the values as read and round each
gradient once to its input's type: dx (summed in an fp32 buffer that the
entry zeroes and rounds) and d_mask bf16, d_offset in the offsets' type.

Every entry has two routes.  The fast route (``exact_bwd_fast``: H and W at
least 2, Cin a multiple of 4 in fp32 or of 8 in bf16, ``dcols``, ``x`` and
dx's sums 16-byte aligned; every DCN and FCB training site) cuts the map
into tiles of output sites (``exact_bwd_plan``) whose footprint, the tiles'
tap grid with a halo of ``FAST_HALO`` pixels, is staged in shared memory;
an item whose block lies in its tile's footprint (``exact_bwd_inside``)
adds its dx there, any other item in device memory.  Every other call
takes the general route, one warp a (site, tap).  The wrapper alone
chooses the route and hands it to the entry, which launches it, or refuses
a fast call that the fast route cannot take.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .build import CudaKernel, check_cuda, records_grad
from .deform_col2im import SMEM_LIMIT, fast_tiling, footprint
from .deform_conv import check_types

# the shape (10 ints), then the route and its plan (8 ints), then the stream
_INTS = [ctypes.c_int] * 18 + [ctypes.c_void_p]
KERNEL = CudaKernel('deform_exact_bwd', 'stmask_deform_exact_bwd',
                    [ctypes.c_void_p] * 8 + _INTS)
# the bf16 entries take one more pointer, dx's fp32 sums, before dx
_BF16 = [ctypes.c_void_p] * 9 + _INTS
KERNEL_BF16 = CudaKernel('deform_exact_bwd', 'stmask_deform_exact_bwd_bf16',
                         _BF16)
KERNEL_BF16_F32OFF = CudaKernel('deform_exact_bwd',
                                'stmask_deform_exact_bwd_bf16_f32off', _BF16)

# The fast route (csrc F_*): chunks of CHUNK channels (a row of 128 bytes
# in fp32, 64 in bf16), FAST_STAGES chunks in the ring, tiles whose
# footprint has a halo of FAST_HALO pixels (at N(0, 1.5) offsets about 0.3%
# of the items overflow), blocks of 512 threads, tiled as K4's fast route.
CHUNK, FAST_STAGES, FAST_HALO = 32, 2, 3


@dataclass(frozen=True)
class ExactBwdPlan:
    """How the fast route cuts one call: tiles of ``ty`` x ``tx`` output
    sites, each with a footprint of ``fh`` x ``fw`` input pixels (its tap
    grid and a halo of ``halo``); ``n_split`` blocks share a tile's channel
    chunks; ``smem`` bytes of shared memory; ``blocks`` in all."""
    ty: int
    tx: int
    fh: int
    fw: int
    halo: int
    n_split: int
    smem: int
    blocks: int


def fast_smem(npix: int, items: int, elem: int) -> int:
    """Shared memory of a fast-route block for ``elem``-byte values (csrc
    ``fast_smem``): the ring of rows (the footprint's pixels and the items,
    CHUNK channels each), per item its dx weights, 4 corner sums, packed
    word and item, per row its source, the buckets' starts (npix + 2) and
    the footprint pass's list with its length (npix + 1)."""
    rows = npix + items
    return (FAST_STAGES * rows * CHUNK * elem + items * (16 + 16 + 4 + 4)
            + rows * 4 + (2 * npix + 3) * 4)


def exact_bwd_fast(h: int, w: int, cin: int, elem: int, x_numel: int,
                   dcols_numel: int, *ptrs: int) -> bool:
    """Whether a call takes the fast route: H and W at least 2, Cin a
    multiple of a lane's channels (16 bytes: 4 fp32 or 8 bf16 of ``elem``
    bytes), every pointer in ``ptrs`` (dcols, x, dx's fp32 sums and, in
    bf16, dx; byte addresses) 16-byte aligned, x and dcols indexed by
    32-bit offsets and an image's pixels by 27 bits."""
    return (h >= 2 and w >= 2 and cin % (16 // elem) == 0
            and all(p % 16 == 0 for p in ptrs) and h * w < 2 ** 27
            and x_numel < 2 ** 31 and dcols_numel < 2 ** 31)


@functools.lru_cache(maxsize=256)
def exact_bwd_plan(b: int, ho: int, wo: int, cin: int, kh: int, kw: int,
                   stride: int = 1, dilation: int = 1, elem: int = 4
                   ) -> ExactBwdPlan:
    """The fast route's plan for ``elem``-byte values: K4's tiling and
    channel split (``deform_col2im.fast_tiling``) under this route's shared
    memory, with footprints of a halo of FAST_HALO pixels.  Raises if the
    tile's footprint does not fit a block's shared memory."""
    def smem(ty, tx):
        fh, fw = footprint(ty, tx, kh, kw, stride, dilation, FAST_HALO)
        return fast_smem(fh * fw, ty * tx * kh * kw, elem)

    ty, tx, n_split = fast_tiling(b, ho, wo, -(-cin // CHUNK), smem)
    fh, fw = footprint(ty, tx, kh, kw, stride, dilation, FAST_HALO)
    if smem(ty, tx) > SMEM_LIMIT:
        raise ValueError(
            f'deform_exact_bwd_cuda: a {fh}x{fw} footprint ({kh}x{kw} taps, '
            f'dilation {dilation}, halo {FAST_HALO}) needs {smem(ty, tx)} B '
            f'of shared memory, over the {SMEM_LIMIT} B a block may take')
    tiles = b * -(-ho // ty) * -(-wo // tx)
    return ExactBwdPlan(ty, tx, fh, fw, FAST_HALO, n_split, smem(ty, tx),
                        tiles * n_split)


def exact_bwd_inside(offset: torch.Tensor, h: int, w: int, kh: int, kw: int,
                     stride: int, dilation: int, plan: ExactBwdPlan
                     ) -> torch.Tensor:
    """[B, Ho*Wo*K] bool: whether each (site, tap)'s clipped 2 x 2 block
    lies in the footprint of its tile under ``plan`` (the fast route's
    inside items, which add their dx in shared memory; the others overflow
    into device memory), as the kernel decides it (H, W >= 2)."""
    b, ho, wo, _ = offset.shape
    k = kh * kw
    dev = offset.device
    rows, cols = exact_geometry(offset, h, w, kh, kw, stride, dilation)
    out = torch.ones(b, ho * wo * k, dtype=torch.bool, device=dev)
    for blk, size, pad, t, span in (
            (rows, ho, (kh - 1) // 2 * dilation, plan.ty, plan.fh),
            (cols, wo, (kw - 1) // 2 * dilation, plan.tx, plan.fw)):
        o = torch.arange(size, device=dev)
        first = (o // t) * t * stride - pad - plan.halo   # footprint origin
        first = (first[:, None] if blk is rows else first[None, :]).expand(
            ho, wo)
        first = first[..., None].expand(ho, wo, k).reshape(1, -1)
        rel = blk[0][0] - first               # the block's origin, relative
        out &= (rel >= 0) & (rel <= span - 2)
    return out


def block_weights(p: torch.Tensor, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight ``clip(1 - |p - u|, 0, 1)`` of the block row (or column)
    ``u`` for the fp32 coordinate ``p``, and JAX's derivative of it with
    respect to p (see the top): ``|d|``'s derivative is 1 at d == 0, and a
    tie of ``maximum`` at 0 or of ``minimum`` at 1 halves it."""
    d = p - u
    z = 1.0 - torch.abs(d)
    lo = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
    hi = torch.where(z == 1, 0.5, 1.0)
    w = torch.clamp(z, 0.0, 1.0)
    return w, torch.where(d >= 0, -lo, lo) * hi


def exact_geometry(offset: torch.Tensor, h: int, w: int, kh: int, kw: int,
                   stride: int = 1, dilation: int = 1):
    """Each (site, tap)'s block of the forward's gather: a list per
    dimension of (pixel index, weight, derivative) for its one or two rows
    and columns, each [B, Ho*Wo*K] (rows and columns as long tensors)."""
    b, ho, wo, _ = offset.shape
    k = kh * kw
    n = ho * wo * k
    f32 = dict(dtype=torch.float32, device=offset.device)
    oy = torch.arange(ho, **f32) * stride - (kh - 1) // 2 * dilation
    ox = torch.arange(wo, **f32) * stride - (kw - 1) // 2 * dilation
    ky = torch.arange(kh, **f32) * dilation
    kx = torch.arange(kw, **f32) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(1, n)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(1, n)
    off = offset.float().reshape(b, n, 2)
    out = []
    for base, d, size in ((base_y, off[..., 0], h), (base_x, off[..., 1], w)):
        p = base + d
        span = min(2, size)
        origin = torch.clamp(torch.floor(p), 0, size - span)
        out.append([(origin.long() + r,) + block_weights(p, origin + r)
                    for r in range(span)])
    return out


def deform_exact_bwd_reference(dcols: torch.Tensor, x: torch.Tensor,
                               offset: torch.Tensor,
                               mask: Optional[torch.Tensor], kh: int,
                               kw: int, stride: int = 1, dilation: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Plain PyTorch (dx, d_offset, d_mask) from ``dcols``.

    Args:
      dcols: [B*Ho*Wo, K*Cin], the gradient of the gathered columns (taps
        outer, channels inner, the modulation applied); x: [B, H, W, Cin];
        offset: [B, Ho, Wo, 2K], (dy, dx) interleaved per tap, raw (not
        clamped); mask: [B, Ho, Wo, K] or None.  All fp32, or dcols, x and
        mask bf16 with bf16 or fp32 offsets.
    Returns:
      dx [B, H, W, Cin], d_offset [B, Ho, Wo, 2K], d_mask [B, Ho, Wo, K] or
      None, each in its input's type (in bf16 computed in fp32 and
      rounded once).
    """
    if x.dtype == torch.bfloat16:
        dx, d_off, d_mask = deform_exact_bwd_reference(
            dcols.float(), x.float(), offset.float(),
            None if mask is None else mask.float(), kh, kw, stride,
            dilation)
        return (dx.to(x.dtype), d_off.to(offset.dtype),
                None if mask is None else d_mask.to(mask.dtype))
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kh * kw
    n = ho * wo * k
    rows, cols = exact_geometry(offset, h, w, kh, kw, stride, dilation)
    m = (mask.reshape(b, n) if mask is not None
         else torch.ones(b, n, dtype=x.dtype, device=x.device))
    dc = dcols.reshape(b, n, cin)
    flat = x.reshape(b, h * w, cin)
    dx = torch.zeros(b * h * w, cin, dtype=x.dtype, device=x.device)
    s_m = torch.zeros(b, n, dtype=x.dtype, device=x.device)
    s_y = torch.zeros_like(s_m)
    s_x = torch.zeros_like(s_m)
    img0 = (torch.arange(b, device=x.device) * (h * w))[:, None]
    for row, wy, dwy in rows:
        for col, wx, dwx in cols:
            idx = row * w + col
            xv = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
            s = (dc * xv).sum(dim=-1)
            s_m = s_m + wy * wx * s
            s_y = s_y + dwy * wx * s
            s_x = s_x + wy * dwx * s
            dx.index_add_(0, (idx + img0).reshape(-1),
                          (dc * (m * wy * wx)[..., None]).reshape(-1, cin))
    d_offset = torch.stack([m * s_y, m * s_x], dim=-1).reshape(b, ho, wo,
                                                               2 * k)
    d_mask = s_m.reshape(b, ho, wo, k) if mask is not None else None
    return dx.reshape(b, h, w, cin), d_offset, d_mask


def deform_exact_bwd_cuda(dcols: torch.Tensor, x: torch.Tensor,
                          offset: torch.Tensor, mask: Optional[torch.Tensor],
                          kh: int, kw: int, stride: int = 1,
                          dilation: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Kernel K5 on contiguous CUDA tensors (shapes and types as above), on
    the route ``exact_bwd_fast`` decides, with ``exact_bwd_plan``'s plan
    on the fast one.  d_offset and d_mask are summed in a fixed order on
    either route, so they are the same bit for bit over two launches."""
    dt = check_types('deform_exact_bwd_cuda', x, offset)
    check_cuda('deform_exact_bwd_cuda', *(t for t in (dcols, x, mask)
                                          if t is not None), dtype=dt)
    check_cuda('deform_exact_bwd_cuda', offset, dtype=offset.dtype)
    b, h, w, cin = x.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_exact_bwd_cuda: offset '
                         f'{tuple(offset.shape)} is not [{b}, Ho, Wo, '
                         f'{2 * k}]')
    _, ho, wo, _ = offset.shape
    if tuple(dcols.shape) != (b * ho * wo, k * cin):
        raise ValueError(f'deform_exact_bwd_cuda: dcols '
                         f'{tuple(dcols.shape)} is not '
                         f'{(b * ho * wo, k * cin)}')
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_exact_bwd_cuda: mask {tuple(mask.shape)} '
                         f'is not {(b, ho, wo, k)}')
    if dcols.numel() >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError('deform_exact_bwd_cuda: dcols and x must have '
                         'fewer than 2^31 elements')
    dx = torch.empty_like(x)
    dx32 = (None if dt == torch.float32 else
            torch.empty(x.shape, dtype=torch.float32, device=x.device))
    sums = (dx if dx32 is None else dx32).data_ptr()
    fast = exact_bwd_fast(h, w, cin, x.element_size(), x.numel(),
                          dcols.numel(), dcols.data_ptr(), x.data_ptr(),
                          sums, *(() if dx32 is None else (dx.data_ptr(),)))
    plan = (exact_bwd_plan(b, ho, wo, cin, kh, kw, stride, dilation,
                           x.element_size()) if fast else None)
    part = (torch.empty(plan.n_split, b * ho * wo * k, 3, device=x.device)
            if plan is not None and plan.n_split > 1 else None)
    d_offset = torch.empty_like(offset)
    d_mask = None if mask is None else torch.empty_like(mask)
    ptrs = (dcols.data_ptr(), x.data_ptr(), offset.data_ptr(),
            None if mask is None else mask.data_ptr())
    route = ((1, plan.ty, plan.tx, plan.fh, plan.fw, plan.halo,
              plan.n_split, plan.smem) if plan is not None else (0,) * 8)
    outs = (d_offset.data_ptr(),
            None if d_mask is None else d_mask.data_ptr(),
            None if part is None else part.data_ptr(),
            b, h, w, cin, ho, wo, kh, kw, stride, dilation, *route,
            torch.cuda.current_stream(x.device).cuda_stream)
    if dt == torch.float32:
        KERNEL(*ptrs, dx.data_ptr(), *outs)
    else:
        kernel = KERNEL_BF16 if offset.dtype == dt else KERNEL_BF16_F32OFF
        kernel(*ptrs, dx32.data_ptr(), dx.data_ptr(), *outs)
    return dx, d_offset, d_mask


def _no_mask(mask, grads):
    """The op's outputs: an empty d_mask stands for None (an op returns
    tensors only)."""
    dx, d_offset, d_mask = grads
    return dx, d_offset, d_mask if mask is not None else dx.new_empty(0)


@torch.library.custom_op('stmask::deform_exact_bwd', mutates_args=(),
                         device_types='cuda')
def _deform_exact_bwd_op(dcols: torch.Tensor, x: torch.Tensor,
                         offset: torch.Tensor, mask: Optional[torch.Tensor],
                         kh: int, kw: int, stride: int, dilation: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    return _no_mask(mask, deform_exact_bwd_cuda(
        dcols, x, offset, mask, kh, kw, stride, dilation))


@_deform_exact_bwd_op.register_kernel('cpu')
def _(dcols, x, offset, mask, kh, kw, stride, dilation):
    return _no_mask(mask, deform_exact_bwd_reference(
        dcols, x, offset, mask, kh, kw, stride, dilation))


@_deform_exact_bwd_op.register_fake
def _(dcols, x, offset, mask, kh, kw, stride, dilation):
    return (torch.empty_like(x), torch.empty_like(offset),
            x.new_empty(0) if mask is None else torch.empty_like(mask))


def deform_exact_bwd(dcols: torch.Tensor, x: torch.Tensor,
                     offset: torch.Tensor, mask: Optional[torch.Tensor],
                     kh: int, kw: int, stride: int = 1, dilation: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    if records_grad(dcols, x, offset, mask):
        if x.device.type == 'cpu':
            return deform_exact_bwd_reference(dcols, x, offset, mask, kh, kw,
                                              stride, dilation)
        return deform_exact_bwd_cuda(dcols, x, offset, mask, kh, kw, stride,
                                     dilation)
    dx, d_offset, d_mask = torch.ops.stmask.deform_exact_bwd(
        dcols, x, offset, mask, kh, kw, stride, dilation)
    return dx, d_offset, d_mask if mask is not None else None
