"""stmask_torch: the PyTorch/CUDA port of stmask-tpu for NVIDIA Hopper.

A second package beside the JAX reference (``stmask_tpu``); it imports
neither JAX nor ``stmask_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``.  The eval video step of the flagship
preset ``STMask_plus_resnet50`` is ported; ROADMAP.md lists the rest.
"""

__version__ = '0.1.0'

from .config import REGISTRY, STMaskConfig, get_config  # noqa: F401
