"""Box geometry on tensors (port of ``stmask_tpu/ops/boxes.py``).

Same math as the JAX package (reference ``layers/box_utils.py``): SSD
variance encode/decode, vectorized crop, pairwise IoU, the DIoU terms of
the box and centerness losses.  Static shapes throughout; no in-place
mutation of inputs.  Where a gradient flows, min/max are ``torch.minimum``
/ ``torch.maximum`` against tensors, which split a tie 0.5/0.5 as JAX
does (``torch.clamp`` gives the whole gradient to the input).

Conventions: point-form boxes are [x1, y1, x2, y2]; priors are
[cx, cy, w, h]; all normalized to [0, 1].
"""

from __future__ import annotations

import torch

# SSD encode/decode variances (reference box_utils.py:223,274).
VARIANCES = (0.1, 0.2)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0 (no NaN from 0/0)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    return torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] -> [cx, cy, w, h]."""
    return torch.cat([(boxes[..., 2:] + boxes[..., :2]) / 2,
                      boxes[..., 2:] - boxes[..., :2]], dim=-1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area, [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    inter = torch.clamp(max_xy - min_xy, min=0.0)
    return inter[..., 0] * inter[..., 1]


def area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0])
            * (boxes[..., 3] - boxes[..., 1]))


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor,
            iscrowd: bool = False) -> torch.Tensor:
    """Pairwise IoU, [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    inter = intersect(box_a, box_b)
    area_a = area(box_a)[..., :, None]
    area_b = area(box_b)[..., None, :]
    union = area_a + area_b - inter
    denom = area_a.expand_as(inter) if iscrowd else union
    return _safe_div(inter, denom)


def elemwise_box_iou(box_a: torch.Tensor, box_b: torch.Tensor
                     ) -> torch.Tensor:
    """IoU of aligned box pairs, [..., 4] x [..., 4] -> [...]."""
    max_xy = torch.minimum(box_a[..., 2:], box_b[..., 2:])
    min_xy = torch.maximum(box_a[..., :2], box_b[..., :2])
    inter = torch.maximum(max_xy - min_xy, max_xy.new_zeros(()))
    inter = inter[..., 0] * inter[..., 1]
    return _safe_div(inter, area(box_a) + area(box_b) - inter)


def encode(matched: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Encode point-form gt against [cx, cy, w, h] priors with SSD
    variances; ``encode(decode(x, p), p) == x`` (reference
    box_utils.py:199-235)."""
    v0, v1 = VARIANCES
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (v0 * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(torch.maximum(g_wh, g_wh.new_tensor(1e-12))) / v1
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Decode network regression to point form (reference
    box_utils.py:237-283)."""
    v0, v1 = VARIANCES
    centers = priors[..., :2] + loc[..., :2] * v0 * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * v1)
    return torch.cat([centers - wh / 2, centers + wh / 2], dim=-1)


def sanitize_coordinates(x1: torch.Tensor, x2: torch.Tensor, img_size: int,
                         padding: int = 0):
    """Scale to absolute, order, clamp (reference box_utils.py:297-316;
    the ``cast=False`` float path)."""
    x1 = x1 * img_size
    x2 = x2 * img_size
    lo = torch.minimum(x1, x2)
    hi = torch.maximum(x1, x2)
    lo = torch.clamp(lo - padding, min=0)
    hi = torch.clamp(hi + padding, max=img_size)
    return lo, hi


def sanitize_coordinates_hw(box: torch.Tensor, h: int, w: int
                            ) -> torch.Tensor:
    """Unnormalize [..., 4] boxes to (h, w) feature coords (reference
    box_utils.py:319-337)."""
    x1, x2 = sanitize_coordinates(box[..., 0], box[..., 2], w)
    y1, y2 = sanitize_coordinates(box[..., 1], box[..., 3], h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def crop(masks: torch.Tensor, boxes: torch.Tensor, padding: int = 1):
    """Zero mask pixels outside each box (reference box_utils.py:340-364).

    Args:
      masks: [..., h, w, n]; boxes: [..., n, 4] normalized point form
        (the same leading dims, e.g. a lane axis).
    Returns:
      (crop_mask, cropped_masks), both [..., h, w, n].
    """
    h, w, _ = masks.shape[-3:]
    x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], w, padding)
    y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], h, padding)
    x1, x2, y1, y2 = (c[..., None, None, :] for c in (x1, x2, y1, y2))

    rows = torch.arange(w, dtype=masks.dtype, device=masks.device)[None, :,
                                                                   None]
    cols = torch.arange(h, dtype=masks.dtype, device=masks.device)[:, None,
                                                                   None]
    crop_mask = ((rows >= x1) & (rows < x2) & (cols >= y1) & (cols < y2))
    crop_mask = crop_mask.to(masks.dtype)
    return crop_mask, masks * crop_mask


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of binary masks [..., n1, h, w] x [..., n2, h, w] ->
    [..., n1, n2] (reference box_utils.py:435-447); the intersection is one
    (batched) matmul."""
    m1 = mask1.flatten(-2)
    m2 = mask2.flatten(-2)
    inter = m1 @ m2.transpose(-1, -2)
    a1 = m1.sum(dim=-1)[..., :, None]
    a2 = m2.sum(dim=-1)[..., None, :]
    return _safe_div(inter, a1 + a2 - inter)


def diou_distance(det_bbox: torch.Tensor, prev_det_bbox: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise DIoU center-distance penalty d^2/c^2, [n, 4] x [m, 4] ->
    [n, m] (reference box_utils.py:450-470)."""
    a, b = det_bbox[:, None, :], prev_det_bbox[None, :, :]
    x_min = torch.minimum(torch.minimum(a[..., 0], a[..., 2]),
                          torch.minimum(b[..., 0], b[..., 2]))
    x_max = torch.maximum(torch.maximum(a[..., 0], a[..., 2]),
                          torch.maximum(b[..., 0], b[..., 2]))
    y_min = torch.minimum(torch.minimum(a[..., 1], a[..., 3]),
                          torch.minimum(b[..., 1], b[..., 3]))
    y_max = torch.maximum(torch.maximum(a[..., 1], a[..., 3]),
                          torch.maximum(b[..., 1], b[..., 3]))
    c2 = (x_max - x_min) ** 2 + (y_max - y_min) ** 2
    det_c = (det_bbox[:, :2] + det_bbox[:, 2:]) / 2
    prev_c = (prev_det_bbox[:, :2] + prev_det_bbox[:, 2:]) / 2
    d2 = ((det_c[:, None, :] - prev_c[None, :, :]) ** 2).sum(dim=2)
    return _safe_div(d2, c2)


def elemwise_diou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """DIoU = IoU - d^2/c^2 for aligned pairs [..., 4] -> [...] (reference
    multibox_loss.py:227-245 get_DIoU)."""
    iou = elemwise_box_iou(pred, gt)
    x_min = torch.minimum(torch.minimum(pred[..., 0], pred[..., 2]),
                          torch.minimum(gt[..., 0], gt[..., 2]))
    x_max = torch.maximum(torch.maximum(pred[..., 0], pred[..., 2]),
                          torch.maximum(gt[..., 0], gt[..., 2]))
    y_min = torch.minimum(torch.minimum(pred[..., 1], pred[..., 3]),
                          torch.minimum(gt[..., 1], gt[..., 3]))
    y_max = torch.maximum(torch.maximum(pred[..., 1], pred[..., 3]),
                          torch.maximum(gt[..., 1], gt[..., 3]))
    c2 = (x_max - x_min) ** 2 + (y_max - y_min) ** 2
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    gc = (gt[..., :2] + gt[..., 2:]) / 2
    d2 = ((pc - gc) ** 2).sum(dim=-1)
    return iou - _safe_div(d2, c2)
