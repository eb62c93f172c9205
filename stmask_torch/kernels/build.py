"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>_<digest>.so
         csrc/<name>.cu

``<digest>`` hashes the sources and flags, so an edited source is rebuilt
and a finished build is reused.  A variant built with preprocessor
definitions (``defines``: the measurement builds of
``kernels/split.py``) hashes them too and lives beside the
library's own build.  nvcc's output (ptxas's registers, shared
memory and spills of each kernel) is kept beside the library as
``lib<name>_<digest>.log`` and read back by ``ptxas_report``.  The build
directory ``_build/`` sits next to this file and is listed in
``.gitignore``.  A failed build raises with nvcc's output; nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin); the '
                       'CUDA kernels are built on a machine with the CUDA '
                       'toolkit')


def _flags(defines: Sequence[str] = ()) -> tuple:
    return NVCC_FLAGS + tuple(f'-D{d}' for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(' '.join(_flags(defines)).encode())
    for src in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}_{h.hexdigest()[:12]}.so'


def build(names: Iterable[str], defines: Sequence[str] = ()) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together, each with ``-D`` of every
    entry of ``defines``.  Returns the wall seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *_flags(defines), '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        out.with_suffix('.log').write_text(log)
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list:
    """ptxas's resource lines (registers, shared memory, spills) from the
    build of ``csrc/<name>.cu``, built if needed."""
    build([name])
    log = library_path(name).with_suffix('.log')
    lines = log.read_text().splitlines() if log.exists() else []
    return [ln.strip() for ln in lines
            if 'Used' in ln or 'spill' in ln or 'entry function' in ln]


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built if needed."""
    key = ' '.join((name,) + tuple(defines))
    if key not in _LIBS:
        build([name], defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        lib.stmask_cuda_error_string.argtypes = [ctypes.c_int]
        lib.stmask_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return _LIBS[key]


class CudaKernel:
    """One exported C launcher of a kernel library, with its launch count.

    The C function enqueues the kernel on the given stream and returns
    ``cudaGetLastError()``; a non-zero code raises here.  ``launches``
    counts successful launches and nothing else.
    """

    def __init__(self, library: str, symbol: str, argtypes: Sequence,
                 defines: Sequence[str] = ()):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.defines = tuple(defines)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.library, self.defines), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = load(self.library, self.defines).stmask_cuda_error_string(
                rc).decode()
            raise RuntimeError(f'{self.symbol}: CUDA error {rc} ({msg})')
        self.launches += 1


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32,
               contiguous: bool = True) -> None:
    """Raise unless every tensor is a CUDA tensor of ``dtype`` on one
    device, and a contiguous one unless ``contiguous`` is False.  A tensor
    that needs a gradient is refused while autograd records: the kernels are
    differentiated only through the ``torch.autograd.Function``s of
    ``ops.correlation`` and ``ops.deform_conv``, whose forward runs with
    recording off."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'{name}: expected CUDA tensors on one device, '
                             f'got {t.device} and {dev}')
        if t.dtype != dtype:
            raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
        if contiguous and not t.is_contiguous():
            raise ValueError(f'{name}: expected contiguous tensors')
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f'{name}: a wrapper records no gradient; call the '
                'differentiable op in stmask_torch.ops instead')


def records_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (None skipped).
    The ``stmask::`` custom ops have no autograd formula, so the wrappers
    send such calls past them: a CPU call to the differentiable plain
    version, a CUDA call to the kernel's wrapper, which refuses it
    (``check_cuda``)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
