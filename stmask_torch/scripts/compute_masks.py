"""How well the model's prototypes can reconstruct the gt masks (the
counterpart of the JAX package's ``scripts/compute_masks.py``):

    python -m stmask_torch.scripts.compute_masks --ann_file A
        --img_prefix P [--config STMask_plus_resnet50] [--trained_model
        model.pth] [--frames 8] [--out_dir DIR] [--img_w W --img_h H]
        [--device cuda|cpu]

Per object, the least-squares coefficients x of ``proto @ x ~= gt`` and the
IoU of the 0.5-binarized fit with the gt: an upper bound on the mask
quality of a linear combination for that frame.  The prototypes come from
the model on ``--device`` (the eval CLI's loader: ``--trained_model``,
else seeded random weights); ``--out_dir`` gets one PNG a frame, the gt
masks above their fits (``utils/visualization.py::proto_grid``).
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch


def fit_protos(proto: np.ndarray, gt_masks: np.ndarray):
    """proto [h, w, k], gt_masks [n, h, w] -> (approx [n, h, w] bool,
    ious [n]): least-squares coefficients then 0.5-binarized IoU."""
    h, w, k = proto.shape
    a = proto.reshape(-1, k).astype(np.float64)
    b = gt_masks.reshape(len(gt_masks), -1).T.astype(np.float64)
    x = np.linalg.lstsq(a, b, rcond=None)[0]           # [k, n]
    approx = (a @ x > 0.5).T.reshape(gt_masks.shape)   # [n, h, w]
    gt = gt_masks > 0.5
    inter = (approx & gt).sum(axis=(1, 2))
    union = (approx | gt).sum(axis=(1, 2))
    return approx, inter / np.maximum(union, 1)


def run(cfg, model, dataset, device, frames: int = 8,
        out_dir: str = None) -> List[float]:
    """Fit the prototypes of up to ``frames`` annotated frames; prints each
    frame's IoUs and the mean, returns every object's IoU."""
    from ..data.image_io import load_image_rgb
    from ..data.transforms import preprocess_frame
    from ..utils.visualization import proto_grid

    @torch.inference_mode()
    def proto_of(image: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(image).to(device)[None]
        return model(x)['proto'][0].float().cpu().numpy()

    done, all_ious = 0, []
    for vid in dataset.video_ids():
        for f in range(dataset.num_frames(vid)):
            if done >= frames:
                break
            annots = dataset.frame_annots(vid, f)
            if not len(annots.boxes):
                continue
            pre = preprocess_frame(cfg, load_image_rgb(
                dataset.frame_path(vid, f)), annots)
            approx, ious = fit_protos(proto_of(pre['image']),
                                      pre['masks_proto'])
            all_ious.extend(ious.tolist())
            print(f'video {vid} frame {f}: best-fit IoUs '
                  f'{sorted((ious * 100).astype(int).tolist(), reverse=True)}')
            if out_dir:
                import cv2
                os.makedirs(out_dir, exist_ok=True)
                maps = np.concatenate([pre['masks_proto'].astype(np.float32),
                                       approx.astype(np.float32)])
                cv2.imwrite(os.path.join(out_dir, f'{vid:05d}_{f:04d}.png'),
                            proto_grid(maps.transpose(1, 2, 0),
                                       cols=len(approx)))
            done += 1
        if done >= frames:
            break
    if all_ious:
        print(f'mean best-fit IoU over {len(all_ious)} objects: '
              f'{np.mean(all_ious):.3f}')
    return all_ious


def main(argv=None) -> int:
    from ..data.ytvis import YTVISDataset
    from ..eval import load_model
    from ..utils.device import resolve_device
    from ._common import add_device
    p = argparse.ArgumentParser()
    p.add_argument('--ann_file', required=True)
    p.add_argument('--img_prefix', required=True)
    p.add_argument('--config', default='STMask_plus_resnet50')
    p.add_argument('--trained_model', default=None)
    p.add_argument('--frames', type=int, default=8)
    p.add_argument('--out_dir', default=None,
                   help='write gt/approx overlay PNGs here')
    p.add_argument('--img_w', type=int, default=None,
                   help='override input width (debug/small-scale runs)')
    p.add_argument('--img_h', type=int, default=None)
    add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    args.nms, args.nms_as_miou = None, False
    cfg, model = load_model(args)
    model = model.to(device=dev, memory_format=torch.channels_last)
    dataset = YTVISDataset(args.ann_file, args.img_prefix,
                           has_annotations=True)
    run(cfg, model, dataset, dev, args.frames, args.out_dir)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
