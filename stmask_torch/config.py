"""Immutable configuration system (the PyTorch port's own copy).

A field-for-field copy of ``stmask_tpu/config.py``; the port keeps its own
so that importing it never imports JAX, and ``tests/test_torch_config.py``
holds every preset equal to the JAX package's registry.

The reference (MinghanLi/STMask) uses a mutable attribute-bag ``Config`` with a
global singleton selected by name via ``eval()`` (reference
``datasets/config.py:68-106,975-987``).  Here we replace that with frozen
dataclasses plus a named registry: every STMask-relevant knob from the
reference presets (``datasets/config.py:616-971``) is reproduced, and configs
are hashable and immutable.

Coordinate conventions (shared by the whole framework):
  * images are NHWC, RGB, normalized with MEANS/STD below;
  * boxes are [x1, y1, x2, y2] normalized to [0, 1] by the *padded* image
    shape (reference ``datasets/transforms.py:80-81``);
  * priors are [cx, cy, w, h] normalized (reference
    ``layers/modules/prediction_head_FC.py:224-247``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# Pixel normalization (RGB order; reference datasets/config.py:27-28 stores
# BGR MEANS but imnormalize converts to RGB with these same values).
MEANS = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)

YTVIS2019_CLASSES = (
    'person', 'giant_panda', 'lizard', 'parrot', 'skateboard', 'sedan',
    'ape', 'dog', 'snake', 'monkey', 'hand', 'rabbit', 'duck', 'cat', 'cow',
    'fish', 'train', 'horse', 'turtle', 'bear', 'motorbike', 'giraffe',
    'leopard', 'fox', 'deer', 'owl', 'surfboard', 'airplane', 'truck',
    'zebra', 'tiger', 'elephant', 'snowboard', 'boat', 'shark', 'mouse',
    'frog', 'eagle', 'earless seal', 'tennis_racket')

YTVIS2021_CLASSES = (
    'airplane', 'bear', 'bird', 'boat', 'car', 'cat', 'cow', 'deer', 'dog',
    'duck', 'earless_seal', 'elephant', 'fish', 'flying_disc', 'fox', 'frog',
    'giant_panda', 'giraffe', 'horse', 'leopard', 'lizard', 'monkey',
    'motorbike', 'mouse', 'parrot', 'person', 'rabbit', 'shark',
    'skateboard', 'snake', 'snowboard', 'squirrel', 'surfboard',
    'tennis_racket', 'tiger', 'train', 'truck', 'turtle', 'whale', 'zebra')

OVIS_CLASSES = (
    'person', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow', 'elephant',
    'bear', 'zebra', 'giraffe', 'poultry', 'giant panda', 'lizard', 'parrot',
    'monkey', 'rabbit', 'tiger', 'fish', 'turtle', 'bicycle', 'motorcycle',
    'airplane', 'boat', 'vehicle')


@dataclass(frozen=True)
class DatasetConfig:
    """Where a dataset lives on disk (reference datasets/config.py:110-218)."""
    name: str = 'ytvis2019'
    img_prefix: str = ''
    ann_file: str = ''
    img_scale: Tuple[int, int] = (640, 360)  # (w, h) before padding
    size_divisor: int = 32
    flip_ratio: float = 0.5
    clip_frames: int = 1
    test_mode: bool = False
    has_gt: bool = True


@dataclass(frozen=True)
class BackboneConfig:
    """ResNet backbone settings (reference datasets/config.py:262-321)."""
    name: str = 'ResNet101'
    depth: int = 101                      # 50 | 101
    # blocks per stage; reference backbone.py:61 args ([3,4,23,3],)
    layers: Tuple[int, ...] = (3, 4, 23, 3)
    # number of trailing DCN blocks per stage + the application interval
    # (reference backbone.py:124-131, config args ([...],[0,4,23,3],3))
    dcn_layers: Tuple[int, ...] = (0, 0, 0, 0)
    dcn_interval: int = 1
    # Window-clamped DCN (TPU deviation): offsets clipped to +-R cells so
    # the bilinear gather and (crucially) its training adjoint become dense
    # static shifts instead of XLA's serialized scatter-add while-loop.
    # 0 disables (exact unclamped gather).  Training uses the window path
    # whenever radius > 0; eval additionally needs dcn_window_eval
    # (default False: imported-checkpoint eval parity stays exact).
    dcn_window_radius: int = 2
    dcn_window_eval: bool = False
    # which backbone stages feed the FPN (C3, C4, C5 == indices 1, 2, 3)
    selected_layers: Tuple[int, ...] = (1, 2, 3)


@dataclass(frozen=True)
class FPNConfig:
    """FPN settings (reference datasets/config.py:360-384,647-651)."""
    num_features: int = 256
    num_downsample: int = 2
    use_conv_downsample: bool = True
    pad: bool = True
    relu_downsample_layers: bool = False
    relu_pred_layers: bool = True
    interpolation_mode: str = 'bilinear'


@dataclass(frozen=True)
class STMaskConfig:
    """Full model + train + eval configuration (one reference preset)."""
    name: str = 'STMask_plus_base'
    dataset: str = 'ytvis2019'
    num_classes: int = 41                 # includes background
    classes: Tuple[str, ...] = YTVIS2019_CLASSES

    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)

    # ---- FCA prediction head (reference config.py:653-659) ----
    share_prediction_module: bool = True
    extra_head_net_channels: int = 256    # [(256, 3, {'padding': 1})]
    extra_layers: Tuple[int, int, int, int] = (2, 2, 2, 2)  # conf,bbox,track,mask
    # multi-kernel head banks: (kh, kw) per bank; anchors are kernel-shaped
    head_kernel_sizes: Tuple[Tuple[int, int], ...] = ((3, 3), (3, 5), (5, 3))
    # pred_scales per FPN level; with a single scale the anchor ratio is 1
    pred_scales: Tuple[Tuple[float, ...], ...] = (
        (24.,), (48.,), (96.,), (192.,), (384.,))
    train_boxes: bool = True
    train_class: bool = True
    train_centerness: bool = True
    train_track: bool = True
    train_masks: bool = True
    embed_dim: int = 128

    # ---- FCB deformable alignment (reference config.py:699-701,746-765) ----
    use_pred_offset: bool = False         # ada=True, ali=False
    use_dcn_class: bool = False
    use_dcn_track: bool = False
    use_dcn_mask: bool = False
    # Training-path window radius for FCB deformable alignment (TPU
    # deviation, same class as backbone dcn_window_radius): the exact
    # gather's autodiff transpose is a scatter-add that XLA:TPU
    # serializes (measured 7.1-8.0 s/step at batch 4 for _ada bf16);
    # the window formulation's adjoint is scatter-free.  Radius 2 chosen
    # by measurement (scripts/dcn_clip_rate.py on the trained _ali
    # checkpoint: worst FCB site max |offset| 1.48, p99 <= 0.43 — 0%
    # clip at radius 2, and 36 vs 64 window terms vs radius 3); eval
    # always uses the exact gather.  0 restores the exact-gather
    # training path.
    fcb_window_radius: int = 2

    # ---- ProtoNet / lincomb masks (reference config.py:661-673) ----
    mask_proto_src: int = 0               # FPN level index (P3)
    mask_proto_n: int = 32
    mask_proto_crop: bool = True
    mask_proto_crop_with_pred_box: bool = True
    mask_proto_prototype_activation: str = 'relu'
    mask_proto_mask_activation: str = 'sigmoid'
    mask_proto_coeff_activation: str = 'tanh'
    discard_mask_area: int = 25
    # prototype regularization 'P': None | 'l1' | 'disj'
    # (reference config.py:450, multibox_loss.py:188-192)
    mask_proto_loss: Optional[str] = None
    # coefficient diversity loss 'D' (reference config.py:456-457 flag,
    # alpha overridden to 5 by STMask_base_config, config.py:635)
    mask_proto_coeff_diversity_loss: bool = False
    mask_proto_coeff_diversity_alpha: float = 5.0
    # direct mask-IoU loss 'MIoU' (reference config.py:713,
    # multibox_loss.py:618-626,638-639)
    use_maskiou_loss: bool = False

    # ---- mask re-scoring (FastMaskIoUNet; reference config.py:596-633,
    # off in every STMask preset but part of the component surface) ----
    use_maskiou: bool = False
    maskiou_alpha: float = 5.0
    rescore_bbox: bool = False
    rescore_mask: bool = False

    # ---- image-level class-existence head (reference config.py:508-509,
    # STMask.py:114-117,300-301) ----
    use_class_existence_loss: bool = False
    class_existence_alpha: float = 1.0

    # ---- prediction-head family: 'fc' = STMask multi-kernel FCA head,
    # 'legacy' = single-kernel YOLACT head (reference prediction_head.py) --
    head_type: str = 'fc'

    # ---- temporal fusion (reference config.py:687-693) ----
    temporal_fusion_module: bool = True
    correlation_patch_size: int = 11
    correlation_selected_layer: int = 1   # index into [P3..P7]? see STMask.py:291
    score_decay: float = 0.95             # TF_utils.py:47
    max_tracked_mask_age: int = 10        # track_TF.py:160

    # ---- tracking (reference config.py:683-685) ----
    match_coeff: Tuple[float, float, float, float] = (0., 1., 2., 0.)
    bbox_dummy_iou: float = 0.3           # track_TF.py:123

    # ---- matching / loss (reference config.py:703-712,624-634) ----
    positive_iou_threshold: float = 0.5
    negative_iou_threshold: float = 0.4
    crowd_iou_threshold: float = 0.7
    ohem_negpos_ratio: int = 3
    conf_alpha: float = 6.125
    bbox_alpha: float = 1.5
    bboxiou_alpha: float = 5.0
    track_alpha: float = 5.0
    mask_alpha: float = 6.125
    center_alpha: float = 20.0
    boxshift_alpha: float = 5.0
    maskshift_alpha: float = 6.125
    maskshift_loss: bool = True
    use_boxiou_loss: bool = True
    use_sigmoid_focal_loss: bool = False
    focal_loss_alpha: float = 0.25
    focal_loss_gamma: float = 2.0
    focal_loss_init_pi: float = 0.01
    use_semantic_segmentation_loss: bool = False
    semantic_segmentation_alpha: float = 1.0
    masks_to_train: int = 100

    # ---- train schedule (reference config.py:397-412,622-623) ----
    lr: float = 1e-3
    momentum: float = 0.9
    decay: float = 1e-4
    gamma: float = 0.1
    lr_steps: Tuple[int, ...] = (150000, 200000)
    max_iter: int = 250000
    lr_warmup_init: float = 1e-4
    lr_warmup_until: int = 500
    freeze_bn: bool = True                # train.py:115-118 per-GPU batch < 6
    # global-norm gradient clipping (0 = off). The reference has none, but
    # with reference-scale frame-sum losses a single saturation spike can
    # produce a finite loss with a >1e6 gradient and destroy the heads in
    # one SGD step. Typical global norms are ~2e3 at init (logged per step
    # as 'gnorm'), so 1e4 leaves normal dynamics untouched and caps only
    # outlier steps.
    grad_clip_norm: float = 1e4

    # ---- eval / NMS (reference config.py:425-436,714-730) ----
    nms_top_k: int = 200
    nms_conf_thresh: float = 0.05
    nms_thresh: float = 0.5
    eval_conf_thresh: float = 0.05
    candidate_conf_thresh: float = 0.05
    max_num_detections: int = 100
    nms_as_miou: bool = False
    # NMS family for eval: 'cc' (cross-class fast NMS -> mAP), 'per_class'
    # (fast NMS -> mAP*), 'greedy' (exact sequential, the Cython-parity
    # path).  Reference README.md:97: mAP and mAP* columns.
    eval_nms_method: str = 'cc'

    # ---- static-shape capacities (TPU additions; no reference analog) ----
    max_gt_per_frame: int = 32            # padded gt capacity for training
    crowd_capacity: int = 8               # padded iscrowd regions per frame
    det_capacity: int = 100               # padded detections after NMS
    track_capacity: int = 128             # padded track-state slots
    shift_capacity: int = 32              # active slots run through TemporalNet

    # ---- training-time augmentation (reference datasets/extra_aug.py,
    # off in every STMask dataset preset — config 'extra_aug': None — and
    # utils/augmentations.py:666 SSDAugmentation for the legacy path) ----
    # 'none' | 'extra' (PhotoMetric+Expand+RandomCrop, mmcv extra_aug)
    # | 'ssd' (legacy YOLACT chain incl. RandomSampleCrop+RandomMirror)
    train_augment: str = 'none'

    # ---- delayed settings (reference config.py:582-584) ----
    # ((iteration, (('field', value), ...)), ...): applied once the training
    # iteration passes the threshold (train.py rebuilds the step program)
    delayed_settings: Tuple = ()

    # ---- input geometry ----
    img_w: int = 640
    img_h: int = 360                      # pre-pad height; padded to 384
    max_size: int = 640

    @property
    def pad_h(self) -> int:
        d = 32
        return ((self.img_h + d - 1) // d) * d

    @property
    def pad_w(self) -> int:
        d = 32
        return ((self.img_w + d - 1) // d) * d

    @property
    def num_head_banks(self) -> int:
        return len(self.head_kernel_sizes)

    @property
    def num_priors_per_loc(self) -> int:
        # banks x scales-per-level (reference: num_priors = len(pred_scales))
        return len(self.head_kernel_sizes) * len(self.pred_scales[0])

    @property
    def num_levels(self) -> int:
        return len(self.backbone.selected_layers) + self.fpn.num_downsample

    def feature_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(h, w) of P3..P7 for the padded input size."""
        shapes = []
        h, w = self.pad_h, self.pad_w
        for lvl in range(self.num_levels):
            stride = 8 * (2 ** lvl)
            shapes.append((max(1, math.ceil(self.pad_h / stride)),
                           max(1, math.ceil(self.pad_w / stride))))
        # downsample levels halve with ceil from the previous level
        out = []
        ph, pw = None, None
        for i, (fh, fw) in enumerate(shapes):
            if i >= len(self.backbone.selected_layers):
                fh = max(1, (ph + 1) // 2)
                fw = max(1, (pw + 1) // 2)
            out.append((fh, fw))
            ph, pw = out[-1]
        return tuple(out)

    @property
    def num_priors(self) -> int:
        a = self.num_priors_per_loc
        return sum(h * w * a for h, w in self.feature_shapes())

    def replace(self, **kw) -> 'STMaskConfig':
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Preset registry mirroring the ~20 named reference configs
# (reference datasets/config.py:616-971).
# --------------------------------------------------------------------------

_R101 = BackboneConfig(name='ResNet101', depth=101, layers=(3, 4, 23, 3))
_R101_DCN = BackboneConfig(name='ResNet101_DCN_Interval3', depth=101,
                           layers=(3, 4, 23, 3), dcn_layers=(0, 4, 23, 3),
                           dcn_interval=3)
_R50 = BackboneConfig(name='ResNet50', depth=50, layers=(3, 4, 6, 3))
_R50_DCN = BackboneConfig(name='ResNet50_DCN_Interval3', depth=50,
                          layers=(3, 4, 6, 3), dcn_layers=(0, 4, 6, 3),
                          dcn_interval=2)

_FCB_ADA = dict(use_pred_offset=True, use_dcn_class=True,
                use_dcn_track=False, use_dcn_mask=False)
_FCB_ALI = dict(use_pred_offset=False, use_dcn_class=True,
                use_dcn_track=False, use_dcn_mask=False)

_base = STMaskConfig(name='STMask_base', backbone=_R101)

_DATASET_OVERRIDES: Dict[str, Dict[str, Any]] = {
    'ytvis2019': dict(dataset='ytvis2019', num_classes=41,
                      classes=YTVIS2019_CLASSES),
    'ytvis2021': dict(dataset='ytvis2021', num_classes=41,
                      classes=YTVIS2021_CLASSES),
    'ovis': dict(dataset='ovis', num_classes=26, classes=OVIS_CLASSES,
                 max_iter=420000),
}


def _build_registry() -> Dict[str, STMaskConfig]:
    reg: Dict[str, STMaskConfig] = {}
    combos = [
        ('STMask_base', _R101, {}),
        ('STMask_plus_base', _R101_DCN, {}),
        ('STMask_plus_base_ada', _R101_DCN, _FCB_ADA),
        ('STMask_plus_base_ali', _R101_DCN, _FCB_ALI),
        ('STMask_resnet50', _R50, {}),
        ('STMask_plus_resnet50', _R50_DCN, {}),
        ('STMask_plus_resnet50_ada', _R50_DCN, _FCB_ADA),
        ('STMask_plus_resnet50_ali', _R50_DCN, _FCB_ALI),
    ]
    for name, bb, fcb in combos:
        reg[name] = _base.replace(name=name, backbone=bb, **fcb)

    # OVIS and YTVIS2021 variants exist for the "plus" configs
    # (reference datasets/config.py:826-971)
    for ds_key, suffix in (('ovis', 'OVIS'), ('ytvis2021', 'YTVIS2021')):
        for base_name in ('STMask_plus_base', 'STMask_plus_base_ada',
                          'STMask_plus_base_ali', 'STMask_plus_resnet50',
                          'STMask_plus_resnet50_ada',
                          'STMask_plus_resnet50_ali'):
            name = f'{base_name}_{suffix}'
            reg[name] = reg[base_name].replace(
                name=name, **_DATASET_OVERRIDES[ds_key])

    # alternative-backbone and legacy-head presets (reference keeps
    # ResNet-GN / DarkNet53 / VGG16 backbones, backbone.py:188-460, and the
    # single-kernel YOLACT PredictionModule, prediction_head.py:15)
    reg['STMask_resnet50_gn'] = _base.replace(
        name='STMask_resnet50_gn',
        backbone=BackboneConfig(name='ResNet50_GN', depth=50,
                                layers=(3, 4, 6, 3)))
    reg['STMask_darknet53'] = _base.replace(
        name='STMask_darknet53',
        backbone=BackboneConfig(name='DarkNet53', layers=(1, 2, 8, 8, 4),
                                selected_layers=(2, 3, 4)))
    reg['STMask_vgg16'] = _base.replace(
        name='STMask_vgg16',
        backbone=BackboneConfig(name='VGG16', layers=(2, 2, 3, 3, 3),
                                selected_layers=(3, 4, 5)))
    reg['YOLACT_legacy_resnet50'] = _base.replace(
        name='YOLACT_legacy_resnet50', backbone=_R50, head_type='legacy',
        train_centerness=False, train_track=False,
        temporal_fusion_module=False, use_boxiou_loss=False)
    return reg


REGISTRY: Dict[str, STMaskConfig] = _build_registry()


def get_config(name: str) -> STMaskConfig:
    """Look up a preset by name; accepts the reference's ``*_config`` suffix."""
    key = name[:-7] if name.endswith('_config') else name
    if key not in REGISTRY:
        raise KeyError(
            f'unknown config {name!r}; available: {sorted(REGISTRY)}')
    return REGISTRY[key]


def config_from_checkpoint_name(path: str) -> Optional[STMaskConfig]:
    """Infer the config from a checkpoint filename like the reference does
    (reference eval.py:773-778, utils/functions.py:96-128).

    Longest-prefix match after stripping the extension — without the
    strip, ``STMask_plus_base_ada.pth`` would fall back to the shorter
    ``STMask_plus_base`` prefix (its last part being ``ada.pth``)."""
    import os
    stem = os.path.basename(path)
    stem = stem.split('.', 1)[0]
    parts = stem.split('_')
    for end in range(len(parts), 0, -1):
        cand = '_'.join(parts[:end])
        if cand in REGISTRY:
            return REGISTRY[cand]
    return None
