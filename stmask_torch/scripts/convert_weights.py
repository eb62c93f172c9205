"""Convert a reference PyTorch STMask checkpoint to the port's own (the
counterpart of the JAX package's ``scripts/convert_weights.py``):

    python -m stmask_torch.scripts.convert_weights --config
        STMask_plus_resnet50 --torch_ckpt STMask_plus_resnet50.pth
        --out weights/converted.pth

The reference's ``state_dict`` keys are the port's parameter names, so the
file overlays the model's seeded initial weights (``init_flax``, as the
JAX script starts from ``model.init``) through
``convert.py::load_reference_weights``: a tensor the file lacks keeps its
initial value and is listed, a key the model lacks is dropped and listed,
a shape mismatch raises.  It saves ``{'model': state_dict}``, what the
eval CLI's ``--trained_model`` and ``overfit_sanity`` read.  Host-only.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import torch


def run(cfg, torch_ckpt: str, out: str) -> Tuple[List[str], List[str]]:
    """Convert and save; returns (kept from the init, dropped)."""
    from ..convert import load_reference_weights
    from ..models.stmask import STMask, init_flax
    model = init_flax(STMask(cfg), torch.Generator().manual_seed(0))
    kept, dropped = load_reference_weights(model, torch_ckpt)
    if kept:
        print('not in checkpoint (init kept):', kept)
    if dropped:
        print('in checkpoint but not model:', dropped)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({'model': model.state_dict()}, out)
    print('wrote', out)
    return kept, dropped


def main(argv=None) -> int:
    from ..config import get_config
    p = argparse.ArgumentParser()
    p.add_argument('--config', required=True)
    p.add_argument('--torch_ckpt', required=True)
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    run(get_config(args.config), args.torch_ckpt, args.out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
