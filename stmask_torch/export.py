"""The serving artifact: the per-frame video step exported with
``torch.export`` (port of ``stmask_tpu/export.py``).

The video step of ``build_video_step`` (or the lockstep-batched step of
``build_video_step_batched``) is traced once with the weights and the
priors inside the program, and written as one ``torch.export.save`` file
whose ``meta.json`` holds the config name, the shapes and types of the
inputs and the tracker state.  A serving host loads it with ``torch`` and
``stmask_torch.kernels`` (which registers the ``stmask::`` ops that the
program calls: the fused deformable conv, the correlation and the greedy
NMS), without the model code or the config.

    exported, meta = export_video_step(cfg, model)            # on cuda
    save_exported(exported, meta, 'model.stmask')

    step, meta = load_exported('model.stmask')                # elsewhere
    state = step.init_state()
    state, out = step(state, frame, is_first)

Unlike the JAX artifact, a program runs on the device type it was
exported for (its kernels are that device's); there is no multi-platform
lowering, and loading it for another device type raises.  A batched
program takes and returns a list of N per-stream states, as
``build_video_step_batched`` does.

CLI: ``python -m stmask_torch.export --out model.stmask [--bf16]
[--batched N --chunk K] [--bench PASSES]`` (``scripts/export_model.py``'s
flags; ``--device`` replaces ``--platforms`` and ``--cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .inference.candidates import Detections
from .inference.tracker import FrameOutput, TrackState

__version__ = '1'

_REGISTERED = False


def _register_pytrees() -> None:
    """Stable serialised names for the NamedTuples that cross the
    program's boundary (the counterpart of JAX's
    ``register_namedtuple_serialization``); registering twice raises."""
    global _REGISTERED
    if _REGISTERED:
        return
    for cls in (TrackState, FrameOutput, Detections):
        pytree._register_namedtuple(
            cls, serialized_type_name=f'stmask_torch.{cls.__name__}')
    _REGISTERED = True


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace('torch.', '')


class _Step(torch.nn.Module):
    """The video step as a module: the model's parameters and buffers
    become the program's weights."""

    def __init__(self, model: torch.nn.Module, step):
        super().__init__()
        self.model = model
        self._step = step

    def forward(self, state, frames, is_first):
        return self._step(state, frames, is_first)


def export_video_step(cfg, model, batched: int = 0, chunk_size: int = 1,
                      uint8_input: bool = True,
                      compute_dtype: torch.dtype = torch.float32,
                      device: torch.device | str = 'cuda'
                      ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Export the video step of ``model`` (moved to ``device``, cast to
    ``compute_dtype``) with its weights.

    The program is ``fn(state, frames, is_first) -> (state, FrameOutput)``.
    ``batched=N`` exports the N-stream ``chunk_size``-frame lockstep step
    (frames [K, N, ...], is_first [K, N], a list of N states);
    ``batched=0`` the single-stream step (frame [H, W, 3], is_first a
    0-dim bool).  ``uint8_input`` takes resized uint8 [img_h, img_w, 3]
    frames, normalized and padded inside; else normalized padded float32
    [pad_h, pad_w, 3] frames."""
    _register_pytrees()
    from .inference.pipeline import build_video_step, build_video_step_batched
    from .utils.device import resolve_device

    dev = resolve_device(device)
    hw = ((cfg.img_h, cfg.img_w) if uint8_input else (cfg.pad_h, cfg.pad_w))
    frame_dtype = torch.uint8 if uint8_input else torch.float32
    if batched:
        step, make_states = build_video_step_batched(
            cfg, model, n_videos=batched, chunk_size=chunk_size,
            uint8_input=uint8_input, device=dev, compute_dtype=compute_dtype)
        states = make_states()
        state0, lane0 = states, states[0]
        frame_shape = (chunk_size, batched) + hw + (3,)
        first_shape = (chunk_size, batched)
    else:
        step, make_state = build_video_step(
            cfg, model, uint8_input=uint8_input, device=dev,
            compute_dtype=compute_dtype)
        state0 = lane0 = make_state()
        frame_shape = hw + (3,)
        first_shape = ()
    frames = torch.zeros(frame_shape, dtype=frame_dtype, device=dev)
    first = torch.ones(first_shape, dtype=torch.bool, device=dev)
    exported = torch.export.export(_Step(model, step),
                                   (state0, frames, first), strict=False)
    meta = {
        'format_version': __version__,
        'config': cfg.name,
        'platforms': [dev.type],
        'batched': batched,
        'chunk_size': chunk_size,
        'uint8_input': uint8_input,
        'frame_shape': list(frame_shape),
        'frame_dtype': _dtype_name(frame_dtype),
        'param_dtype': _dtype_name(next(model.parameters()).dtype),
        'img_shape': [cfg.img_h, cfg.img_w],
        'pad_shape': [cfg.pad_h, cfg.pad_w],
        'track_capacity': cfg.track_capacity,
        'state': {k: [list(v.shape), _dtype_name(v.dtype)]
                  for k, v in lane0._asdict().items()},
        'torch_version': torch.__version__,
    }
    return exported, meta


def save_exported(exported: torch.export.ExportedProgram,
                  meta: Dict[str, Any], path: str) -> None:
    """Write the artifact: the program, its weights and ``meta.json``.
    The example inputs are left out, so loading unpickles nothing beyond
    tensors."""
    _register_pytrees()
    exported.example_inputs = None
    with warnings.catch_warnings(), open(path, 'wb') as f:
        # the packager calls every weight that is not contiguous in the
        # default layout incomplete, the model's channels-last 3x3 and 7x7
        # kernels among them, and writes its dense storage with its
        # strides, which the loader restores (tests/test_torch_export.py
        # holds the loaded weights equal to the model's, layout included)
        warnings.filterwarnings('ignore', message='No complete tensor')
        torch.export.save(exported, f, extra_files={
            'meta.json': json.dumps(meta, indent=1)})


class ExportedStep:
    """A loaded artifact: ``step(state, frames, is_first)`` and
    ``init_state()``, the empty tracker state(s) from the metadata."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], device: torch.device):
        self.meta = meta
        self.device = device
        self._fn = program.module()

    def __call__(self, state, frames, is_first):
        frames = torch.as_tensor(frames).to(self.device, non_blocking=True)
        first = torch.as_tensor(is_first, dtype=torch.bool).to(self.device)
        with torch.inference_mode():
            return self._fn(state, frames, first)

    def init_state(self):
        """An empty bank (every field zero), or a list of ``batched``."""
        def one():
            return TrackState(**{
                k: torch.zeros(shape, dtype=getattr(torch, dt),
                               device=self.device)
                for k, (shape, dt) in self.meta['state'].items()})
        n = int(self.meta['batched'])
        return [one() for _ in range(n)] if n else one()


def load_exported(path: str, device: Optional[torch.device | str] = None
                  ) -> Tuple[ExportedStep, Dict[str, Any]]:
    """Load an artifact on the device it was exported on (a CUDA artifact:
    the card of that index).  ``device``, when given, must be of that
    type: another raises."""
    _register_pytrees()
    from . import kernels  # noqa: F401  (registers the stmask:: ops)
    from .utils.device import resolve_device

    meta = read_meta(path)
    if meta.get('format_version') != __version__:
        raise ValueError(f'artifact format {meta.get("format_version")!r} '
                         f'!= supported {__version__!r}')
    kind = meta['platforms'][0]
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f'{path} was exported for {kind}; it does not run '
                         f'on {torch.device(device).type} (export it there)')
    resolve_device(kind)                  # raises on cuda without a GPU
    with open(path, 'rb') as f:
        program = torch.export.load(f)
    dev = next(iter(program.state_dict.values())).device
    return ExportedStep(program, meta, dev), meta


def read_meta(path: str) -> Dict[str, Any]:
    """The artifact's ``meta.json``, read without loading the program."""
    with zipfile.ZipFile(path) as z:
        name, = [n for n in z.namelist() if n.endswith('/extra/meta.json')]
        return json.loads(z.read(name))


# ---------------------------------------------------------------- the CLI

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='export the video step to a serving artifact')
    p.add_argument('--config', default=None)
    p.add_argument('--trained_model', default=None,
                   help="a reference-keyed .pth or the port's checkpoint, "
                        'holding every tensor of the model; the config '
                        'follows its name unless --config is given '
                        '(seeded random weights without it, for smoke '
                        'tests)')
    p.add_argument('--out', required=True, help='the artifact to write')
    p.add_argument('--batched', type=int, default=0,
                   help='export the N-stream lockstep step (0: the '
                        'single-stream per-frame step)')
    p.add_argument('--chunk', type=int, default=1,
                   help='frames a call with --batched')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 weights and compute')
    p.add_argument('--float_input', action='store_true',
                   help='take normalized padded float frames, not resized '
                        'uint8 ones')
    p.add_argument('--device', default='cuda',
                   help="the device the artifact runs on: 'cuda' "
                        "(default) or 'cpu'")
    p.add_argument('--bench', type=int, default=0, metavar='PASSES',
                   help='reload the artifact and time PASSES passes of '
                        '~200 frames (median frames/s)')
    p.add_argument('--nms', default=None,
                   choices=['cc', 'per_class', 'greedy'])
    p.add_argument('--nms_as_miou', action='store_true')
    p.add_argument('--img_w', type=int, default=None)
    p.add_argument('--img_h', type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.bench < 0:
        raise SystemExit(f'--bench must be >= 0, got {args.bench}')
    from .eval import load_model

    # as the eval CLI: the config from --config, else from the checkpoint's
    # name; a checkpoint that lacks any of the model's tensors raises
    cfg, model = load_model(args)
    t0 = time.perf_counter()
    exported, meta = export_video_step(
        cfg, model, batched=args.batched, chunk_size=args.chunk,
        uint8_input=not args.float_input,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device)
    t1 = time.perf_counter()
    save_exported(exported, meta, args.out)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f'wrote {args.out} ({size_mb:.1f} MB) in {t1 - t0:.1f} s export '
          f'+ {time.perf_counter() - t1:.1f} s save: config={meta["config"]}'
          f' platforms={meta["platforms"]} batched={meta["batched"]} '
          f'chunk={meta["chunk_size"]} frame={meta["frame_shape"]} '
          f'{meta["frame_dtype"]} weights={meta["param_dtype"]}', flush=True)
    if args.bench:
        bench_artifact(args.out, args.bench)
    return 0


def bench_artifact(path: str, repeats: int, target_frames: int = 200,
                   device: Optional[str] = None) -> Dict[str, Any]:
    """Reload ``path`` as a serving host would (``load_exported``, no model
    code) and time ``repeats`` passes of about ``target_frames`` frames,
    each ended by a read of the outputs; prints one JSON line with the
    median, least and most frames/s (``scripts/export_model.py:93-151``)."""
    t0 = time.perf_counter()
    step, meta = load_exported(path, device)
    load_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(0)
    shape = meta['frame_shape']
    if meta['frame_dtype'] == 'uint8':
        frames = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    else:
        frames = torch.randn(shape, generator=g)
    frames = frames.to(step.device)
    batched = int(meta['batched'])
    per_call = meta['chunk_size'] * batched if batched else 1
    if batched:
        first = torch.zeros((meta['chunk_size'], batched), dtype=torch.bool)
        first_start = first.clone()
        first_start[0] = True
    else:
        first, first_start = torch.tensor(False), torch.tensor(True)
    n_calls = max(1, target_frames // per_call)

    def drain(out):
        return float(out.box.float().sum())

    # a video start resets the bank on the first warm-up call
    state, out = step(step.init_state(), frames, first_start)
    for _ in range(2):
        state, out = step(state, frames, first)
    drain(out)
    fps = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(n_calls):
            state, out = step(state, frames, first)
        drain(out)
        fps.append(n_calls * per_call / (time.perf_counter() - t))
    fps.sort()
    rec = {'metric': 'serving_artifact_fps', 'artifact': path,
           'batched': batched, 'chunk': meta['chunk_size'],
           'repeats': repeats, 'value': fps[len(fps) // 2],
           'min': fps[0], 'max': fps[-1], 'unit': 'frames/s',
           'load_s': load_s}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    sys.exit(main())
