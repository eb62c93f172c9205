"""Render the gt annotations of every frame of a YouTube-VIS set (the
counterpart of the JAX package's ``scripts/display_gt_annotations.py``):

    python -m stmask_torch.scripts.display_gt_annotations --ann_file A
        --img_prefix P [--out_dir results/gt_anno] [--max_videos N]
        [--mask_alpha 0.45] [--config STMask_plus_resnet50]

Each annotation's mask (RLE or polygons) alpha-blended in its object's
colour, its box and class name drawn (``utils/visualization.py::
draw_detections``), one PNG a frame.  Host-only.
"""

from __future__ import annotations

import argparse
import os


def run(cfg, dataset, out_dir: str, max_videos: int = -1,
        mask_alpha: float = 0.45) -> int:
    """Write the overlays; returns the number of frames written."""
    import cv2

    from ..data.image_io import load_image_rgb
    from ..utils.visualization import draw_detections
    os.makedirs(out_dir, exist_ok=True)
    vids = dataset.video_ids()
    if max_videos > 0:
        vids = vids[:max_videos]
    n = 0
    for vid in vids:
        for f in range(dataset.num_frames(vid)):
            img = load_image_rgb(dataset.frame_path(vid, f))
            ann = dataset.frame_annots(vid, f)
            over = draw_detections(
                img, ann.boxes, ann.labels, None,
                masks=ann.masks.astype(bool) if len(ann.masks) else None,
                obj_ids=ann.ids, class_names=cfg.classes,
                mask_alpha=mask_alpha)
            cv2.imwrite(os.path.join(out_dir, f'{vid:05d}_{f:04d}.png'),
                        cv2.cvtColor(over, cv2.COLOR_RGB2BGR))
            n += 1
        print(f'video {vid}: {dataset.num_frames(vid)} frames rendered')
    return n


def main(argv=None) -> int:
    from ..config import get_config
    from ..data.ytvis import YTVISDataset
    p = argparse.ArgumentParser()
    p.add_argument('--ann_file', required=True)
    p.add_argument('--img_prefix', required=True)
    p.add_argument('--out_dir', default='results/gt_anno')
    p.add_argument('--max_videos', type=int, default=-1)
    p.add_argument('--mask_alpha', type=float, default=0.45)
    p.add_argument('--config', default='STMask_plus_resnet50',
                   help='config supplying the class-name table')
    args = p.parse_args(argv)
    dataset = YTVISDataset(args.ann_file, args.img_prefix,
                           has_annotations=True)
    run(get_config(args.config), dataset, args.out_dir, args.max_videos,
        args.mask_alpha)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
