"""Video inference: detect, track, postprocess.

The names below load their modules on first use, so that
``inference.tracker`` and ``inference.candidates`` import without the
model (an exported artifact's loader, ``stmask_torch.export``, needs only
their NamedTuples)."""

import importlib

_LAZY = {'build_video_step': 'pipeline', 'build_video_step_batched':
         'pipeline', 'cast_model': 'pipeline',
         'postprocess_frame': 'postprocess',
         'results2json_videoseg': 'postprocess'}
__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__),
                       name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
