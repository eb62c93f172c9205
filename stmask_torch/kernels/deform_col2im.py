"""Backward of the window-clamped deformable gather (col2im): CUDA kernel
K4 (fp32 and bf16 entries) and its plain version.

Replaces the custom VJP of ``stmask_tpu/ops/deform_conv.py::
_make_window_gather`` together with the autodiff of the hat weights and the
modulation in ``deform_conv2d_window`` (``deform_conv.py:152-351``).
``deform_col2im`` calls the custom op ``stmask::deform_col2im``, which
dispatches on the device: CPU tensors take ``deform_col2im_reference``,
CUDA tensors take the kernel in ``csrc/deform_col2im.cu`` or raise.

The kernel accumulates dx in shared memory over the input footprint of a
tile of output sites; ``col2im_plan`` chooses the tile and computes the
footprint, its shared memory and the channel split, and the kernel takes
them as they are.

The offset gradient follows JAX's subgradients of the hat weight
``max(0, 1 - |d - u|)`` at the corner u: -sign(d - u) inside the hat, -1
where d == u (JAX's d|x|/dx is 1 at 0), -0.5 * sign(d - u) where
|d - u| == 1 (``jnp.maximum`` splits a tie), 0 beyond and for a corner
outside the window [-r, r + 1].  It is not DCNv2's floor-based rule: at an
integer offset the two differ (``csrc/deform_col2im.cu`` has the formulas).

The bf16 entries (bf16 ``dcols``, ``x`` and mask; the offsets bf16, or fp32
beside bf16 data) compute in fp32 from the values as read and round each
gradient to its input's type, as the JAX package's VJP types them: dx and
d_mask bf16, d_offset bf16 or fp32.  dx sums in an fp32 buffer first,
which the entry zeroes and rounds into dx.  They have two routes.  The
fast route (``col2im_fast``: Cin a multiple of 8, ``dcols``, ``x``, dx and
its fp32 buffer 16-byte aligned; every DCN site of R50, R101 and FCB) keeps
the bf16 rows in shared memory, copied by ``cp.async`` into a ring of two
chunks, and takes tiles of up to 8 x 8 sites (``col2im_plan(...,
fast=True)``).  Every other bf16 call takes the general route, the fp32
kernel's design on bf16.  The wrapper alone chooses the route and hands it
to the bf16 entry, which launches it, or refuses a fast call that the
fast route cannot take.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .build import CudaKernel, check_cuda, records_grad
from .deform_conv import check_types

_INTS = [ctypes.c_int] * 17 + [ctypes.c_void_p]
KERNEL = CudaKernel('deform_col2im', 'stmask_deform_col2im',
                    [ctypes.c_void_p] * 8 + _INTS)
# the bf16 entries take one more pointer, dx's fp32 sums, and the route (1
# the fast route, 0 the general one) before the stream
_BF16 = [ctypes.c_void_p] * 9 + _INTS[:-1] + [ctypes.c_int, ctypes.c_void_p]
KERNEL_BF16 = CudaKernel('deform_col2im', 'stmask_deform_col2im_bf16', _BF16)
KERNEL_BF16_F32OFF = CudaKernel('deform_col2im',
                                'stmask_deform_col2im_bf16_f32off', _BF16)

CHUNK = 32                    # channels a block stages at a time (csrc CC)
SMEM_LIMIT = 232448           # shared memory one block may take on sm_90
SMEM_TARGET = 65536           # at most this much lets 3 blocks share an SM
BLOCKS = 4 * 132              # 4 blocks on each of the H100's 132 SMs
TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 8), (2, 4), (2, 2), (1, 2),
         (1, 1))
# The bf16 fast route (csrc F_*): tiles of at most FAST_TILE x FAST_TILE
# sites, FAST_STAGES chunks in the ring, blocks of 512 threads, two an SM
# where their shared memory allows (the SM's SMEM_SM bytes, 1024 of them
# reserved a block).  A block's set-up (the items' geometry and their sort)
# takes about FAST_SETUP chunks' time: the channel split weighs it.
FAST_TILE, FAST_STAGES, FAST_SETUP = 8, 2, 1
SMS, SMEM_SM = 132, 233472
FAST_SMEM = SMEM_SM // 2 - 1024


@dataclass(frozen=True)
class Col2imPlan:
    """How K4 cuts one call: tiles of ``ty`` x ``tx`` output sites, each
    with a footprint of ``fh`` x ``fw`` input pixels; ``n_split`` blocks
    share a tile's channel chunks; ``smem`` bytes of shared memory;
    ``route`` 'general' or (bf16) 'fast', with ``stages`` chunks in its
    ring."""
    ty: int
    tx: int
    fh: int
    fw: int
    n_split: int
    smem: int
    blocks: int
    route: str = 'general'
    stages: int = 1


def footprint(ty: int, tx: int, kh: int, kw: int, stride: int,
              dilation: int, radius: int) -> Tuple[int, int]:
    """(rows, cols) of the input pixels that a tile's windows can reach:
    the taps' spread, the tile's own, and the corners [-r, r + 1]."""
    return ((ty - 1) * stride + (kh - 1) * dilation + 2 * radius + 2,
            (tx - 1) * stride + (kw - 1) * dilation + 2 * radius + 2)


def footprint_origin(oy0: int, ox0: int, kh: int, kw: int, stride: int,
                     dilation: int, radius: int) -> Tuple[int, int]:
    """The input pixel at the footprint's top-left corner for the tile whose
    first output site is (oy0, ox0), as the kernel computes it."""
    return (oy0 * stride - (kh - 1) // 2 * dilation - radius,
            ox0 * stride - (kw - 1) // 2 * dilation - radius)


def fast_smem(npix: int, items: int) -> int:
    """Shared memory of a fast-route block (csrc ``fast_smem``): the ring of
    bf16 rows (the footprint's pixels and the items, CHUNK channels each),
    per item its anchor weights, 9 corner sums, packed word and bucket
    slot, per row its source, per pixel a bucket's start and cursor."""
    rows = npix + items
    return (FAST_STAGES * rows * CHUNK * 2 + items * (16 + 4 * 9 + 4 + 4)
            + rows * 4 + (2 * npix + 1) * 4)


def col2im_fast(cin: int, x_numel: int, dcols_numel: int,
                *ptrs: int) -> bool:
    """Whether a bf16 call takes the fast route: Cin a multiple of 8, every
    pointer in ``ptrs`` (dcols, x, dx's fp32 sums and dx; byte addresses)
    16-byte aligned, and x and dcols indexed by 32-bit offsets."""
    return (cin % 8 == 0 and all(p % 16 == 0 for p in ptrs)
            and x_numel < 2 ** 31 and dcols_numel < 2 ** 31)


def fast_tiling(b: int, ho: int, wo: int, chunks: int, smem
                ) -> Tuple[int, int, int]:
    """(ty, tx, n_split) of a fast route (K4's bf16 one, K5's) whose block
    of a ty x tx tile takes ``smem(ty, tx)`` bytes: the tile of at most
    FAST_TILE x FAST_TILE sites that cuts the map into the fewest tiles
    while two blocks share an SM (else 1 x 1), the smaller on a tie, evened
    out over the map (each as small as its count of tiles allows); then the
    channel split with the fewest waves of blocks times chunks a block (and
    its set-up), the smaller on a tie, never a split without a chunk."""
    def even(t, n):
        return -(-n // -(-n // t)) if n else 1

    def tiles_of(t):
        return -(-max(ho, 1) // t[0]) * -(-max(wo, 1) // t[1])

    fits = [(even(ty, ho), even(tx, wo))
            for ty in range(1, FAST_TILE + 1) for tx in range(1, FAST_TILE + 1)
            if smem(even(ty, ho), even(tx, wo)) <= FAST_SMEM]
    ty, tx = min(fits or [(1, 1)], key=lambda t: (tiles_of(t), smem(*t)))
    tiles = b * -(-ho // ty) * -(-wo // tx)
    per_sm = max(1, min(2, SMEM_SM // (smem(ty, tx) + 1024)))

    def cost(s):
        return (-(-tiles * s // (SMS * per_sm))
                * (-(-chunks // s) + FAST_SETUP))

    n_split = min(range(1, chunks + 1), key=lambda s: (cost(s), s))
    return ty, tx, -(-chunks // -(-chunks // n_split))


@functools.lru_cache(maxsize=256)
def _fast_plan(b, ho, wo, cin, kh, kw, stride, dilation,
               radius) -> Col2imPlan:
    """The bf16 fast route's plan (``fast_tiling``)."""
    def smem(ty, tx):
        fh, fw = footprint(ty, tx, kh, kw, stride, dilation, radius)
        return fast_smem(fh * fw, ty * tx * kh * kw)

    ty, tx, n_split = fast_tiling(b, ho, wo, -(-cin // CHUNK), smem)
    fh, fw = footprint(ty, tx, kh, kw, stride, dilation, radius)
    if smem(ty, tx) > SMEM_LIMIT:
        raise ValueError(
            f'deform_col2im_cuda: a {fh}x{fw} footprint ({kh}x{kw} taps, '
            f'dilation {dilation}, radius {radius}) needs {smem(ty, tx)} B '
            f'of shared memory, over the {SMEM_LIMIT} B a block may take')
    tiles = b * -(-ho // ty) * -(-wo // tx)
    return Col2imPlan(ty, tx, fh, fw, n_split, smem(ty, tx), tiles * n_split,
                      'fast', FAST_STAGES)


def col2im_plan(b: int, ho: int, wo: int, cin: int, kh: int, kw: int,
                stride: int = 1, dilation: int = 1, radius: int = 2,
                fast: bool = False) -> Col2imPlan:
    """The general route's plan: the largest tile of ``TILES`` whose shared
    memory lets 3 or 4 blocks share an SM (else 1x1), then a channel split
    into as few parts as give ``BLOCKS`` blocks, or one per chunk.  With
    ``fast``, the bf16 fast route's (``_fast_plan``).  Raises if the tile's
    footprint does not fit a block's shared memory."""
    if fast:
        return _fast_plan(b, ho, wo, cin, kh, kw, stride, dilation, radius)

    def smem(ty, tx):     # a chunk of x over the footprint and of dcols,
        # and each row's source (8 bytes); per (site, tap) 20 words of corner
        # weights, 3 sums and a bucket slot; per footprint pixel a bucket's
        # start and cursor
        fh, fw = footprint(ty, tx, kh, kw, stride, dilation, radius)
        items = ty * tx * kh * kw
        return 4 * ((fh * fw + items) * (CHUNK + 2) + items * (20 + 3 + 1)
                    + 2 * fh * fw + 2)

    ty, tx = next((t for t in TILES if smem(*t) <= SMEM_TARGET), (1, 1))
    fh, fw = footprint(ty, tx, kh, kw, stride, dilation, radius)
    if smem(ty, tx) > SMEM_LIMIT:
        raise ValueError(
            f'deform_col2im_cuda: a {fh}x{fw} footprint ({kh}x{kw} taps, '
            f'dilation {dilation}, radius {radius}) needs {smem(ty, tx)} B '
            f'of shared memory, over the {SMEM_LIMIT} B a block may take')
    tiles = b * -(-ho // ty) * -(-wo // tx)
    chunks = -(-cin // CHUNK)
    n_split = min(chunks, -(-BLOCKS // tiles)) if tiles else 1
    n_split = -(-chunks // -(-chunks // n_split))   # no split without a chunk
    return Col2imPlan(ty, tx, fh, fw, n_split, smem(ty, tx), tiles * n_split)


def _hat(d_off: torch.Tensor, u: torch.Tensor, radius: int):
    """Hat weight and JAX's derivative of it for corner ``u``."""
    d = d_off - u.to(d_off.dtype)
    z = 1.0 - torch.abs(d)
    in_win = ((u >= -radius) & (u <= radius + 1)).to(d_off.dtype)
    fac = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
    h = torch.clamp(z, min=0.0) * in_win
    dh = torch.where(d >= 0, -fac, fac) * in_win
    return h, dh


def deform_col2im_reference(dcols: torch.Tensor, x: torch.Tensor,
                            offset: torch.Tensor,
                            mask: Optional[torch.Tensor], kh: int, kw: int,
                            stride: int = 1, dilation: int = 1,
                            radius: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       Optional[torch.Tensor]]:
    """Plain PyTorch (dx, d_offset, d_mask) from ``dcols``.

    Args:
      dcols: [B*Ho*Wo, K*Cin], the gradient of K2's ``cols`` (taps outer,
        channels inner); x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2K], (dy, dx)
        interleaved and already clamped to [-radius, radius]; mask:
        [B, Ho, Wo, K] or None.  All fp32, or dcols, x and mask bf16 with
        bf16 or fp32 offsets.
    Returns:
      dx [B, H, W, Cin], d_offset [B, Ho, Wo, 2K] (before the clamp's own
      factor), d_mask [B, Ho, Wo, K] or None, each in its input's type (in
      bf16 computed in fp32 and rounded).
    """
    if x.dtype == torch.bfloat16:
        dx, d_off, d_mask = deform_col2im_reference(
            dcols.float(), x.float(), offset.float(),
            None if mask is None else mask.float(), kh, kw, stride,
            dilation, radius)
        return (dx.to(x.dtype), d_off.to(offset.dtype),
                None if mask is None else d_mask.to(mask.dtype))
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kh * kw
    n = ho * wo * k
    pad_h = (kh - 1) // 2 * dilation
    pad_w = (kw - 1) // 2 * dilation
    dev = x.device
    oy = torch.arange(ho, device=dev) * stride - pad_h
    ox = torch.arange(wo, device=dev) * stride - pad_w
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(1, n)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(1, n)
    off = offset.reshape(b, n, 2)
    dy, dxo = off[..., 0], off[..., 1]
    fy, fx = torch.floor(dy).long(), torch.floor(dxo).long()
    m = mask.reshape(b, n) if mask is not None else torch.ones_like(dy)
    dc = dcols.reshape(b, n, cin)
    flat = x.reshape(b, h * w, cin)
    ys = [_hat(dy, fy - 1 + j, radius) + (base_y + fy - 1 + j,)
          for j in range(3)]
    xs = [_hat(dxo, fx - 1 + i, radius) + (base_x + fx - 1 + i,)
          for i in range(3)]
    dx = torch.zeros(b * h * w, cin, dtype=x.dtype, device=dev)
    s_m = torch.zeros_like(dy)
    s_y = torch.zeros_like(dy)
    s_x = torch.zeros_like(dy)
    img0 = (torch.arange(b, device=dev) * (h * w))[:, None]
    for hy, dhy, row in ys:
        for hx, dhx, col in xs:
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            idx = row.clamp(0, h - 1) * w + col.clamp(0, w - 1)
            xv = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
            s = (dc * xv).sum(dim=-1) * inside
            wgt = hy * hx
            s_m = s_m + wgt * s
            s_y = s_y + dhy * hx * s
            s_x = s_x + hy * dhx * s
            contrib = dc * (m * wgt * inside)[..., None]
            dx.index_add_(0, (idx + img0).reshape(-1),
                          contrib.reshape(-1, cin))
    d_offset = torch.stack([m * s_y, m * s_x], dim=-1).reshape(b, ho, wo,
                                                               2 * k)
    d_mask = s_m.reshape(b, ho, wo, k) if mask is not None else None
    return dx.reshape(b, h, w, cin), d_offset, d_mask


def deform_col2im_cuda(dcols: torch.Tensor, x: torch.Tensor,
                       offset: torch.Tensor, mask: Optional[torch.Tensor],
                       kh: int, kw: int, stride: int = 1, dilation: int = 1,
                       radius: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Kernel K4 on contiguous CUDA tensors (shapes and types as above)."""
    dt = check_types('deform_col2im_cuda', x, offset)
    check_cuda('deform_col2im_cuda', *(t for t in (dcols, x, mask)
                                       if t is not None), dtype=dt)
    check_cuda('deform_col2im_cuda', offset, dtype=offset.dtype)
    b, h, w, cin = x.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_col2im_cuda: offset {tuple(offset.shape)} '
                         f'is not [{b}, Ho, Wo, {2 * k}]')
    _, ho, wo, _ = offset.shape
    if tuple(dcols.shape) != (b * ho * wo, k * cin):
        raise ValueError(f'deform_col2im_cuda: dcols {tuple(dcols.shape)} is '
                         f'not {(b * ho * wo, k * cin)}')
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_col2im_cuda: mask {tuple(mask.shape)} is '
                         f'not {(b, ho, wo, k)}')
    if radius < 1:
        raise ValueError(f'deform_col2im_cuda: radius {radius} < 1')
    dx = torch.zeros_like(x) if dt == torch.float32 else torch.empty_like(x)
    dx32 = (None if dt == torch.float32 else
            torch.empty(x.shape, dtype=torch.float32, device=x.device))
    fast = dx32 is not None and col2im_fast(
        cin, x.numel(), dcols.numel(), dcols.data_ptr(), x.data_ptr(),
        dx32.data_ptr(), dx.data_ptr())
    plan = col2im_plan(b, ho, wo, cin, kh, kw, stride, dilation, radius,
                       fast)
    d_offset = torch.empty_like(offset)
    d_mask = None if mask is None else torch.empty_like(mask)
    part = (torch.empty(plan.n_split, b * ho * wo * k, 3, device=x.device)
            if plan.n_split > 1 else None)
    ptrs = (dcols.data_ptr(), x.data_ptr(), offset.data_ptr(),
            None if mask is None else mask.data_ptr())
    outs = (d_offset.data_ptr(),
            None if d_mask is None else d_mask.data_ptr(),
            None if part is None else part.data_ptr(),
            b, h, w, cin, ho, wo, kh, kw, stride, dilation, radius, plan.ty,
            plan.tx, plan.fh, plan.fw, plan.n_split, plan.smem)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if dt == torch.float32:
        KERNEL(*ptrs, dx.data_ptr(), *outs, stream)
    else:
        kernel = KERNEL_BF16 if offset.dtype == dt else KERNEL_BF16_F32OFF
        kernel(*ptrs, dx32.data_ptr(), dx.data_ptr(), *outs, int(fast),
               stream)
    return dx, d_offset, d_mask


def _no_mask(mask, grads):
    """The op's outputs: an empty d_mask stands for None (an op returns
    tensors only)."""
    dx, d_offset, d_mask = grads
    return dx, d_offset, d_mask if mask is not None else dx.new_empty(0)


@torch.library.custom_op('stmask::deform_col2im', mutates_args=(),
                         device_types='cuda')
def _deform_col2im_op(dcols: torch.Tensor, x: torch.Tensor,
                      offset: torch.Tensor, mask: Optional[torch.Tensor],
                      kh: int, kw: int, stride: int, dilation: int,
                      radius: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _no_mask(mask, deform_col2im_cuda(
        dcols, x, offset, mask, kh, kw, stride, dilation, radius))


@_deform_col2im_op.register_kernel('cpu')
def _(dcols, x, offset, mask, kh, kw, stride, dilation, radius):
    return _no_mask(mask, deform_col2im_reference(
        dcols, x, offset, mask, kh, kw, stride, dilation, radius))


@_deform_col2im_op.register_fake
def _(dcols, x, offset, mask, kh, kw, stride, dilation, radius):
    return (torch.empty_like(x), torch.empty_like(offset),
            x.new_empty(0) if mask is None else torch.empty_like(mask))


def deform_col2im(dcols: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], kh: int, kw: int,
                  stride: int = 1, dilation: int = 1, radius: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    if records_grad(dcols, x, offset, mask):
        if x.device.type == 'cpu':
            return deform_col2im_reference(dcols, x, offset, mask, kh, kw,
                                           stride, dilation, radius)
        return deform_col2im_cuda(dcols, x, offset, mask, kh, kw, stride,
                                  dilation, radius)
    dx, d_offset, d_mask = torch.ops.stmask.deform_col2im(
        dcols, x, offset, mask, kh, kw, stride, dilation, radius)
    return dx, d_offset, d_mask if mask is not None else None
