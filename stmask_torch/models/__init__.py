"""The STMask network in PyTorch (eval branch)."""

from .stmask import STMask, build_model, init_random  # noqa: F401
