"""stmask_torch: the PyTorch/CUDA port of stmask-tpu for NVIDIA Hopper.

A second package beside the JAX reference (``stmask_tpu``); it imports
neither JAX nor ``stmask_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``.  The flagship preset
``STMask_plus_resnet50`` is ported for eval (the video steps, fp32 and
bf16, and the eval CLI ``python -m stmask_torch.eval``) and for training;
ROADMAP.md lists the rest.
"""

__version__ = '0.1.0'

from .config import REGISTRY, STMaskConfig, get_config  # noqa: F401
