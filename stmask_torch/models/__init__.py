"""The STMask network in PyTorch (eval and train branches)."""

from .stmask import STMask, build_model, init_random  # noqa: F401
