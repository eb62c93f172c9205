"""The port stands alone: no JAX, no stmask_tpu, and no quiet CPU fallback."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r'''
import importlib, pkgutil, sys
import stmask_torch
for m in pkgutil.walk_packages(stmask_torch.__path__, 'stmask_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'flax',
                                            'stmask_tpu')))
print('BAD', bad)
'''


def test_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == 'BAD []', res.stdout


def test_sources_import_no_jax():
    pat = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|stmask_tpu)\b',
                     re.M)
    files = sorted((ROOT / 'stmask_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']
    assert len(files) > 20
    hits = [f'{f}: {m.group(0).strip()}' for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits


def test_default_device_is_cuda_and_raises_without_gpu():
    from stmask_torch.config import get_config
    from stmask_torch.inference import build_video_step
    from stmask_torch.models import STMask

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    from stmask_torch.train.train_step import build_train_step

    cfg = get_config('STMask_plus_resnet50').replace(img_h=96, img_w=128)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_video_step(cfg, STMask(cfg))
    with pytest.raises(RuntimeError, match='CUDA'):
        build_train_step(cfg, STMask(cfg))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU; only the dispatchers
    route CPU tensors to the plain versions."""
    from stmask_torch.kernels.correlation import correlate_cuda
    from stmask_torch.kernels.correlation_bwd import correlation_bwd_cuda
    from stmask_torch.kernels.deform_col2im import deform_col2im_cuda
    from stmask_torch.kernels.deform_conv import deform_conv_cuda
    from stmask_torch.kernels.deform_im2col import deform_im2col_cuda

    x = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match='CUDA'):
        correlate_cuda(x, x)
    with pytest.raises(ValueError, match='CUDA'):
        correlation_bwd_cuda(torch.zeros(1, 4, 5, 121), x, x)
    with pytest.raises(ValueError, match='CUDA'):
        deform_col2im_cuda(torch.zeros(20, 72), x, torch.zeros(1, 4, 5, 18),
                           None, 3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        deform_im2col_cuda(x, torch.zeros(1, 4, 5, 18), None, 3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        deform_conv_cuda(x, torch.zeros(1, 4, 5, 18),
                         torch.zeros(3, 3, 3, 8), None, None)


def test_unported_paths_raise():
    """Paths outside the ported slices raise instead of running something
    else."""
    from stmask_torch.config import get_config
    from stmask_torch.inference.candidates import detect_frame
    from stmask_torch.models import STMask
    from stmask_torch.train.train_step import build_train_step

    small = dict(img_h=96, img_w=128)
    with pytest.raises(NotImplementedError, match='ROADMAP A.10'):
        STMask(get_config('STMask_plus_resnet50_ada').replace(**small))
    cfg = get_config('STMask_plus_resnet50').replace(**small)
    for kw in (dict(remat=True), dict(compute_dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match='ROADMAP A.9'):
            build_train_step(cfg, STMask(cfg), device='cpu', **kw)
    with pytest.raises(NotImplementedError, match='ROADMAP A.9'):
        build_train_step(cfg.replace(freeze_bn=False), STMask(cfg),
                         device='cpu')
    for method in ('per_class', 'greedy'):
        with pytest.raises(NotImplementedError, match='ROADMAP A.11'):
            detect_frame(cfg.replace(eval_nms_method=method), {}, None)
