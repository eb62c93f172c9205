"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = 'cuda') -> torch.device:
    """The torch device to run on.  ``cuda`` (the default) raises when no
    GPU is visible: nothing drops to the CPU unless the caller asks for it.

    On CUDA this also turns TF32 off for cuDNN convolutions and cuBLAS
    matmuls (a process-wide setting), so the card computes in the same
    float32 arithmetic that the CPU parity tests hold against JAX."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA requested but torch.cuda.is_available() is False; '
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev
