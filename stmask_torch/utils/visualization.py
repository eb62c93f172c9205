"""Debug and display overlays on the host, cv2 and numpy (port of
``stmask_tpu/utils/visualization.py``; reference ``layers/visualization.py``
and the display helpers of ``layers/output_utils.py:136-244``): detection
overlays (box, mask, class, score, track id), prototype grids,
correlation-patch maps, box-shift overlays, the prototype
linear-combination breakdown, FPN activation grids, the image
un-normalization for display, and the training overlays of
``--vis_every``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..config import MEANS, STD, STMaskConfig

# box display palette (reference datasets/config.py COLORS)
COLORS = ((244, 67, 54), (233, 30, 99), (156, 39, 176), (103, 58, 183),
          (63, 81, 181), (33, 150, 243), (3, 169, 244), (0, 188, 212),
          (0, 150, 136), (76, 175, 80), (139, 195, 74), (205, 220, 57),
          (255, 235, 59), (255, 193, 7), (255, 152, 0), (255, 87, 34),
          (121, 85, 72), (158, 158, 158), (96, 125, 139))


def undo_image_transformation(img: np.ndarray, img_h: int,
                              img_w: int) -> np.ndarray:
    """Normalized padded NHWC float image -> uint8 RGB at image size
    (reference output_utils.py:136-165)."""
    img = img[:img_h, :img_w]
    img = img * np.asarray(STD, np.float32) + np.asarray(MEANS, np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_detections(img_rgb: np.ndarray, boxes: np.ndarray,
                    classes: np.ndarray, scores: Optional[np.ndarray],
                    masks: Optional[np.ndarray] = None,
                    obj_ids: Optional[np.ndarray] = None,
                    class_names: Optional[Sequence[str]] = None,
                    mask_alpha: float = 0.45) -> np.ndarray:
    """Overlay boxes/masks/labels; boxes in pixel xyxy, masks [n, H, W].
    ``scores=None`` renders gt-style labels (class name only)."""
    out = img_rgb.copy()
    for i in range(len(boxes)):
        color = COLORS[(int(obj_ids[i]) if obj_ids is not None else i)
                       % len(COLORS)]
        x1, y1, x2, y2 = [int(v) for v in boxes[i]]
        if masks is not None:
            m = masks[i].astype(bool)
            out[m] = (out[m] * (1 - mask_alpha)
                      + np.asarray(color) * mask_alpha).astype(np.uint8)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        name = (class_names[int(classes[i]) - 1] if class_names
                else str(int(classes[i])))
        label = name if scores is None else f'{name}: {scores[i]:.2f}'
        if obj_ids is not None:
            label = f'#{int(obj_ids[i])} ' + label
        cv2.putText(out, label, (x1, max(12, y1 - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
    return out


def proto_grid(proto: np.ndarray, cols: int = 8) -> np.ndarray:
    """[H, W, K] prototypes -> one tiled grayscale grid image
    (reference display_protos/display_lincomb spirit)."""
    h, w, k = proto.shape
    rows = (k + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w), np.float32)
    for i in range(k):
        r, c = divmod(i, cols)
        p = proto[..., i]
        rng = p.max() - p.min()
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = \
            (p - p.min()) / (rng if rng > 0 else 1)
    return (grid * 255).astype(np.uint8)


def correlation_patch_map(corr: np.ndarray, y: int, x: int,
                          patch_size: int = 11) -> np.ndarray:
    """[H, W, patch^2] cost volume -> the displacement heatmap at (y, x)
    (reference display_correlation_map_patch)."""
    m = corr[y, x].reshape(patch_size, patch_size)
    rng = m.max() - m.min()
    m = (m - m.min()) / (rng if rng > 0 else 1)
    return (m * 255).astype(np.uint8)


def draw_box_shift(img_rgb: np.ndarray, box_ref: np.ndarray,
                   box_shift: np.ndarray) -> np.ndarray:
    """Reference-frame box (blue) vs shifted box (green)
    (reference display_box_shift)."""
    out = img_rgb.copy()
    for b, col in ((box_ref, (33, 150, 243)), (box_shift, (76, 175, 80))):
        for i in range(len(b)):
            x1, y1, x2, y2 = [int(v) for v in b[i]]
            cv2.rectangle(out, (x1, y1), (x2, y2), col, 2)
    return out


def display_lincomb(proto: np.ndarray, coeff: np.ndarray,
                    grid: tuple = (8, 4)) -> Dict[str, np.ndarray]:
    """Prototype linear-combination breakdown for ONE detection
    (reference ``layers/output_utils.py:168-222`` display_lincomb).

    Sorts the coefficients by |value| and tiles (a) each prototype scaled
    by its coefficient and (b) the sigmoid-binarized running total after
    adding it, plus the final assembled soft mask.

    Args:
      proto: [h, w, k] prototypes (post proto-activation).
      coeff: [k] activated (tanh-ed) coefficients of one detection.
    Returns:
      {'proto_grid': [h*rows, w*cols], 'running_grid': same, 'mask': [h, w]}.
    """
    ph, pw, k = proto.shape
    rows, cols = grid
    idx = np.argsort(-np.abs(coeff))
    arr_img = np.zeros((ph * rows, pw * cols), np.float32)
    arr_run = np.zeros_like(arr_img)
    running = np.zeros((ph, pw), np.float32)
    for i in range(min(rows * cols, k)):
        y, x = divmod(i, cols)
        p = proto[..., idx[i]].astype(np.float32)
        running = running + p * coeff[idx[i]]
        sl = (slice(y * ph, (y + 1) * ph), slice(x * pw, (x + 1) * pw))
        arr_img[sl] = p / max(float(p.max()), 1e-6) * coeff[idx[i]]
        arr_run[sl] = (1.0 / (1.0 + np.exp(-running)) > 0.5)
    final = 1.0 / (1.0 + np.exp(-(proto.astype(np.float32) @ coeff)))
    return {'proto_grid': arr_img, 'running_grid': arr_run, 'mask': final}


def _upsample_masks(masks: np.ndarray, h: int, w: int,
                    thresh: float = 0.5) -> Optional[np.ndarray]:
    """[n, hp, wp] soft/binary masks -> [n, h, w] bool at display size."""
    if len(masks) == 0:
        return None
    return np.stack([cv2.resize(m.astype(np.float32), (w, h)) > thresh
                     for m in masks])


def render_train_output(cfg: STMaskConfig, image: np.ndarray,
                        priors: np.ndarray, frame_preds: Dict,
                        conf_t: np.ndarray, gt: Dict,
                        max_det: int = 20) -> Dict[str, np.ndarray]:
    """Render the matched-positive predictions and the gt of ONE training
    frame (reference ``layers/train_output_utils.py:14``
    display_train_output: 'train' pane = decoded boxes + assembled masks of
    every positive prior, 'gt' pane = the annotations).

    Args:
      image: [H, W, 3] normalized padded frame (as fed to the model).
      priors: [P, 4] cxcywh priors.
      frame_preds: per-frame slices {'loc' [P,4], 'conf' [P,C],
        'mask_coeff' [P,K], 'proto' [hp,wp,K]}.
      conf_t: [P] matched class targets (>0 = positive) from match_batch.
      gt: {'boxes' [G,4] normalized xyxy, 'labels' [G], 'valid' [G],
        'masks_proto' [G,hp,wp], 'ids' [G]}.
    Returns:
      {'train': uint8 RGB overlay, 'gt': uint8 RGB overlay}.
    """
    from ..ops.boxes import decode
    h, w = image.shape[:2]
    img = undo_image_transformation(image, h, w)

    pos = np.nonzero(np.asarray(conf_t) > 0)[0][:max_det]
    loc = np.asarray(frame_preds['loc'])[pos]
    conf = np.asarray(frame_preds['conf'])[pos]
    e = np.exp(conf - conf.max(-1, keepdims=True)) if len(pos) else conf
    prob = e / e.sum(-1, keepdims=True) if len(pos) else conf
    boxes_n = decode(torch.from_numpy(loc), torch.from_numpy(
        np.asarray(priors)[pos])).numpy() if len(pos) \
        else np.zeros((0, 4), np.float32)
    proto = np.asarray(frame_preds['proto'], np.float32)
    coeff = np.tanh(np.asarray(frame_preds['mask_coeff'], np.float32)[pos])
    masks = _upsample_masks(
        1.0 / (1.0 + np.exp(-(proto @ coeff.T))).transpose(2, 0, 1)
        if len(pos) else np.zeros((0, 1, 1)), h, w)
    train_img = draw_detections(
        img, boxes_n * [w, h, w, h],
        prob[:, 1:].argmax(-1) + 1 if len(pos) else np.zeros(0),
        prob[:, 1:].max(-1) if len(pos) else np.zeros(0),
        masks, class_names=cfg.classes)

    val = np.nonzero(np.asarray(gt['valid']))[0]
    gt_masks = _upsample_masks(np.asarray(gt['masks_proto'])[val], h, w)
    gt_img = draw_detections(
        img, np.asarray(gt['boxes'])[val] * [w, h, w, h],
        np.asarray(gt['labels'])[val], None, gt_masks,
        obj_ids=np.asarray(gt['ids'])[val], class_names=cfg.classes)
    return {'train': train_img, 'gt': gt_img}


def save_train_output(cfg: STMaskConfig, model: torch.nn.Module,
                      batch: Dict[str, torch.Tensor], out_dir: str,
                      epoch: int, iteration: int,
                      max_images: int = 1) -> None:
    """Debug hook behind ``train --vis_every``: run the train-mode forward
    on the step's batch (the train step's batch, on the model's device),
    match, and write 'train' / 'gt' (and, for two-frame clips, 'gt_ref')
    overlay PNGs named ``{epoch}_{iteration}_{i}_{pane}.png`` (reference
    train.py display_train_output call sites).

    The forward runs under ``torch.no_grad()`` and changes nothing of the
    model: no parameter, buffer (the frozen BN statistics are never
    updated), ``training`` flag or random state."""
    import os

    from ..ops.anchors import all_priors
    from ..train.losses import match_batch

    os.makedirs(out_dir, exist_ok=True)
    images = batch['images']                              # [B, F, H, W, 3]
    b, f = images.shape[:2]
    with torch.no_grad():
        preds = model(images, train=True)
        priors = torch.as_tensor(all_priors(cfg), device=images.device)
        gt = {k: batch[k].reshape((b * f,) + batch[k].shape[2:])
              for k in ('boxes', 'labels', 'ids', 'valid')}
        conf_t = match_batch(cfg, priors, preds, gt).conf_t
    host = lambda t: t.detach().float().cpu().numpy()    # noqa: E731
    images = host(images)
    gt = {k: v.cpu().numpy() for k, v in gt.items()}
    conf_t = conf_t.cpu().numpy()
    masks_proto = batch['masks_proto'].cpu().numpy()
    masks_proto = masks_proto.reshape((b * f,) + masks_proto.shape[2:])
    priors = priors.cpu().numpy()
    for i in range(min(max_images, b)):
        fi = i * f                                        # first frame of clip
        frame_preds = {k: host(preds[k][fi])
                       for k in ('loc', 'conf', 'mask_coeff', 'proto')}
        panes = render_train_output(
            cfg, images[i, 0], priors, frame_preds, conf_t[fi],
            {'boxes': gt['boxes'][fi], 'labels': gt['labels'][fi],
             'valid': gt['valid'][fi], 'ids': gt['ids'][fi],
             'masks_proto': masks_proto[fi]})
        if f > 1:
            # gt of the clip's other (next) frame: the reference's third
            # 'gt_last' pane (train_output_utils.py:67-80)
            h, w = images.shape[2:4]
            img1 = undo_image_transformation(images[i, 1], h, w)
            val = np.nonzero(gt['valid'][fi + 1])[0]
            panes['gt_ref'] = draw_detections(
                img1, gt['boxes'][fi + 1][val] * [w, h, w, h],
                gt['labels'][fi + 1][val], None,
                _upsample_masks(masks_proto[fi + 1][val], h, w),
                obj_ids=gt['ids'][fi + 1][val], class_names=cfg.classes)
        for name, im in panes.items():
            cv2.imwrite(os.path.join(
                out_dir, f'{epoch}_{iteration}_{i}_{name}.png'),
                cv2.cvtColor(im, cv2.COLOR_RGB2BGR))


def display_fpn_outs(fpn_outs, grid: tuple = (4, 4)) -> Dict[str, np.ndarray]:
    """Channel-activation grids of the FPN pyramid (reference
    ``layers/output_utils.py:225-244`` display_fpn_outs / ``eval.py:65``
    --display_fpn_outs).

    Args:
      fpn_outs: sequence of [h, w, c] feature maps (P3..P7, NHWC; the
        reference tiles the first ``grid[0]*grid[1]`` channels of each
        NCHW level: the same channels).
    Returns:
      {'P3': [h*rows, w*cols], 'P4': ..., ...} one tiled grid per level.
    """
    rows, cols = grid
    grids = {}
    for lvl, feat in enumerate(fpn_outs):
        f = np.asarray(feat, np.float32)
        h, w, c = f.shape
        arr = np.zeros((h * rows, w * cols), np.float32)
        for i in range(min(rows * cols, c)):
            y, x = divmod(i, cols)
            arr[y * h:(y + 1) * h, x * w:(x + 1) * w] = f[..., i]
        grids[f'P{lvl + 3}'] = arr
    return grids
