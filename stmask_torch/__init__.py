"""stmask_torch: the PyTorch/CUDA port of stmask-tpu for NVIDIA Hopper.

A second package beside the JAX reference (``stmask_tpu``); it imports
neither JAX nor ``stmask_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``.  Every preset of ``config.py`` builds;
the eval video steps (fp32 and bf16) and training are ported, with both
CLIs and all their modes: ``python -m stmask_torch.eval`` (batched,
``--sequential``, ``--benchmark``, ``--display*``, ``--video_dir``,
``--coco``, ``--metrics_only``) and ``python -m stmask_torch.train``
(``--vis_every`` included).  ROADMAP.md lists the rest (multi-GPU,
export, bf16 training).
"""

__version__ = '0.1.0'

from .config import REGISTRY, STMaskConfig, get_config  # noqa: F401
