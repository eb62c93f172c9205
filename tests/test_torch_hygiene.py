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
    from stmask_torch.inference.pipeline import build_video_step_batched
    with pytest.raises(RuntimeError, match='CUDA'):
        build_video_step_batched(cfg, STMask(cfg), 2, 2,
                                 compute_dtype=torch.bfloat16)


def test_eval_cli_default_device_raises_without_gpu(tmp_path):
    """``python -m stmask_torch.eval`` runs on the card unless asked for
    the CPU: without a GPU, the default flags raise."""
    from stmask_torch import eval as t_eval
    from stmask_torch.data.synthetic import write_ytvis_set

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    ann, prefix = write_ytvis_set(str(tmp_path), 1, 2, 24, 32)
    argv = ['--ann_file', ann, '--img_prefix', prefix, '--img_h', '96',
            '--img_w', '128', '--mask_det_file', str(tmp_path / 'r.json')]
    for mode in ([], ['--sequential']):
        with pytest.raises(RuntimeError, match='CUDA'):
            t_eval.main(argv + mode)
    assert not (tmp_path / 'r.json').exists()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU; only the dispatchers
    route CPU tensors to the plain versions."""
    from stmask_torch.kernels.correlation import correlate_cuda
    from stmask_torch.kernels.correlation_bwd import correlation_bwd_cuda
    from stmask_torch.kernels.deform_col2im import deform_col2im_cuda
    from stmask_torch.kernels.deform_conv import deform_conv_cuda
    from stmask_torch.kernels.deform_im2col import deform_im2col_cuda
    from stmask_torch.kernels.greedy_nms import greedy_nms_cuda

    x = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match='CUDA'):
        greedy_nms_cuda(torch.zeros(2, 5, 5), torch.ones(2, 5, dtype=bool),
                        0.5)
    with pytest.raises(ValueError, match='CUDA'):
        correlate_cuda(x, x)
    with pytest.raises(ValueError, match='CUDA'):
        correlation_bwd_cuda(torch.zeros(1, 4, 5, 121), x, x)
    with pytest.raises(ValueError, match='CUDA'):
        correlation_bwd_cuda(torch.zeros(1, 4, 5, 121), x, x, 11,
                             out=torch.zeros(1, 4, 5, 121))
    with pytest.raises(ValueError, match='CUDA'):
        deform_col2im_cuda(torch.zeros(20, 72), x, torch.zeros(1, 4, 5, 18),
                           None, 3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        deform_im2col_cuda(x, torch.zeros(1, 4, 5, 18), None, 3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        deform_conv_cuda(x, torch.zeros(1, 4, 5, 18),
                         torch.zeros(3, 3, 3, 8), None, None)
    xb = x.bfloat16()           # the bf16 variants alike
    with pytest.raises(ValueError, match='CUDA'):
        correlate_cuda(xb, xb)
    with pytest.raises(ValueError, match='CUDA'):
        deform_conv_cuda(xb, torch.zeros(1, 4, 5, 18).bfloat16(),
                         torch.zeros(3, 3, 3, 8).bfloat16(), None, None)
    with pytest.raises(ValueError, match='CUDA'):   # fp32 offsets (FCB ali)
        deform_conv_cuda(xb, torch.zeros(1, 4, 5, 18),
                         torch.zeros(3, 3, 3, 8).bfloat16(), None, None)
    with pytest.raises(TypeError, match='offsets'):  # no other mix
        deform_conv_cuda(x, torch.zeros(1, 4, 5, 18).bfloat16(),
                         torch.zeros(3, 3, 3, 8), None, None)


def test_unported_paths_raise():
    """Paths outside the ported slices raise instead of running something
    else."""
    from stmask_torch.config import get_config
    from stmask_torch.models import STMask
    from stmask_torch.train.train_step import build_train_step

    import dataclasses
    small = dict(img_h=96, img_w=128)
    cfg = get_config('STMask_plus_resnet50').replace(**small)
    # training through the exact gather (radius 0: the DCN sites, or FCB;
    # A.9e) is ported: each model builds and takes its training forward,
    # and nothing in the package names the item
    # (tests/test_torch_exact_gather_bwd.py and test_torch_train_exact.py
    # hold it against JAX)
    clip = torch.zeros(1, 2, cfg.pad_h, cfg.pad_w, 3)
    for name, kw in (
            ('STMask_plus_resnet50', dict(backbone=dataclasses.replace(
                cfg.backbone, dcn_window_radius=0))),
            ('STMask_plus_resnet50_ada', dict(fcb_window_radius=0)),
            ('STMask_plus_resnet50_ali', dict(fcb_window_radius=0))):
        model = STMask(get_config(name).replace(**small, **kw))
        out = model(clip, train=True)
        assert out['loc'].requires_grad and out['conf'].requires_grad
    hits = [f for f in sorted((ROOT / 'stmask_torch').rglob('*.py'))
            if 'A.9e' in f.read_text()]
    assert not hits, hits
    # remat and bf16 training (A.9c) are ported: both build, another
    # compute dtype raises (tests/test_torch_train_remat_bf16.py holds the
    # steps against the plain step and JAX's bf16 step)
    for kw in (dict(remat=True), dict(compute_dtype=torch.bfloat16),
               dict(remat=True, compute_dtype=torch.float32)):
        step, init = build_train_step(cfg, STMask(cfg), device='cpu', **kw)
        assert callable(step) and init().step == 0
    with pytest.raises(ValueError, match='compute_dtype'):
        build_train_step(cfg, STMask(cfg), device='cpu',
                         compute_dtype=torch.float16)
    # the eval CLI's other modes and the training overlays (A.7b) are
    # ported: nothing in the package names the item or the old label
    # (tests/test_torch_eval_modes.py, _coco.py and _visualization.py hold
    # them against JAX)
    hits = [f for f in sorted((ROOT / 'stmask_torch').rglob('*.py'))
            if 'A.7b' in f.read_text() or 'ROADMAP "Next"' in f.read_text()]
    assert not hits, hits
    from stmask_torch import overfit_sanity
    args = overfit_sanity.parse_args(['--bf16', '--remat'])
    assert args.bf16 and args.remat
    hits = [f for f in sorted((ROOT / 'stmask_torch').rglob('*.py'))
            if 'A.9c' in f.read_text()]
    assert not hits, hits
    # the rest of the model surface (A.12) is ported: nothing in the
    # package raises naming it, the flags build their modules, the other
    # backbones build, and the legacy preset's training branch runs
    # (tests/test_torch_backbones_extra.py, _maskiou.py, _losses_extra.py
    # and test_torch_legacy.py hold them against JAX)
    hits = [f for f in sorted((ROOT / 'stmask_torch').rglob('*.py'))
            if 'A.12' in f.read_text()]
    assert not hits, hits
    flags = STMask(cfg.replace(use_maskiou=True,
                               use_semantic_segmentation_loss=True,
                               use_class_existence_loss=True))
    assert {'maskiou_net', 'semantic_seg_conv', 'class_existence_fc'} <= {
        n for n, _ in flags.named_children()}
    for name in ('STMask_resnet50_gn', 'STMask_darknet53', 'STMask_vgg16'):
        with torch.device('meta'):
            STMask(get_config(name).replace(**small))
    legacy = STMask(get_config('YOLACT_legacy_resnet50').replace(**small))
    assert set(legacy(clip, train=True)) == {'loc', 'conf', 'mask_coeff',
                                             'proto'}


@pytest.mark.parametrize('name', sorted(
    ['correlation', 'correlation_bf16', 'deform_im2col', 'deform_conv',
     'deform_conv_bf16', 'deform_conv_bf16_f32off', 'correlation_bwd',
     'deform_col2im', 'deform_wgrad', 'greedy_nms', 'greedy_nms_boxes',
     'correlation_bwd_bf16',
     'deform_col2im_bf16', 'deform_col2im_bf16_f32off', 'deform_wgrad_bf16',
     'deform_wgrad_bf16_f32off', 'deform_exact_bwd', 'deform_exact_bwd_bf16',
     'deform_exact_bwd_bf16_f32off']))
def test_kernel_argtypes_match_the_c_launchers(name):
    """ctypes passes what ``argtypes`` says: each launcher's list must
    follow its C signature (pointer -> c_void_p, int -> c_int, float ->
    c_float), or a call on the card fails or cuts a pointer to 32 bits."""
    import ctypes

    from stmask_torch.kernels import KERNELS
    from stmask_torch.kernels.build import CSRC
    kern = KERNELS[name]
    src = (CSRC / f'{kern.library}.cu').read_text()
    sig = re.search(r'extern "C" int ' + kern.symbol + r'\(([^)]*)\)', src)
    assert sig, kern.symbol
    params = [p.strip() for p in sig.group(1).split(',')]
    scalar = {'int': ctypes.c_int, 'float': ctypes.c_float}
    assert all('*' in p or p.split()[0] in scalar for p in params), params
    want = [ctypes.c_void_p if '*' in p else scalar[p.split()[0]]
            for p in params]
    assert kern.argtypes == want, (kern.symbol, params)


_IMPORT_ONE = r'''
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(n for n in sys.modules
             if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'flax',
                                            'stmask_tpu',
                                            'stmask_torch.models'))))
'''


@pytest.mark.parametrize('module', [
    'stmask_torch.parallel', 'stmask_torch.parallel.mesh',
    'stmask_torch.parallel.collectives', 'stmask_torch.export',
    'stmask_torch.utils.hostguard'])
def test_new_modules_stand_alone(module):
    """Each module of the multi-process, export and host-guard slice
    imports alone in a fresh process, with no JAX and no stmask_tpu; the
    artifact's loader (``stmask_torch.export``) and the collectives also
    without the model code."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', _IMPORT_ONE, module],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == '[]', res.stdout
