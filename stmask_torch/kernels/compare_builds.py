"""Whether a kernel library's code for some entries changed between two
source trees, on a machine with nvcc and cuobjdump.

    python -m stmask_torch.kernels.compare_builds LIBRARY OTHER_CSRC \
        [--match EfE] [--builds 8]

builds ``csrc/<LIBRARY>.cu`` of this tree and ``OTHER_CSRC/<LIBRARY>.cu``
(for example the parent commit's ``csrc`` from ``git archive``) ``--builds``
times each, all at once, to PTX and to SASS with the library's own flags,
and compares the kernel functions whose mangled names hold ``--match``
(``EfE``: the fp32 instantiations of a kernel templated on its element
type).  nvcc 12.8 does not give the same PTX or SASS for every kernel on
every run, so a function counts as unchanged when each of this tree's
builds equals one of the other tree's builds; the lines also say how many
functions vary between the other tree's own builds.  Prints ``[compare]``
lines; exits 1 when a function's PTX matches none of the other tree's.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from .build import CSRC, NVCC_FLAGS, _nvcc


def _norm(name: str) -> str:
    """A mangled name without the anonymous namespace's per-file hash."""
    return re.sub(r'_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}', 'ANON',
                  name)


def _sass(lib: Path) -> dict:
    tool = str(Path(_nvcc()).parent / 'cuobjdump')
    out = subprocess.run([tool, '-sass', str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.match(r'\s*Function : (\S+)', ln)
        if m:
            cur = _norm(m.group(1))
            funcs[cur] = []
        elif cur and re.match(r'\s*/\*[0-9a-f]{4}\*/', ln):
            funcs[cur].append(re.sub(r'/\*[0-9a-f]{4}\*/', '', ln).strip())
    return funcs


def _ptx(path: Path) -> dict:
    funcs, cur = {}, None
    for ln in path.read_text().splitlines():
        m = re.match(r'(?:\.visible )?\.entry (\S+)\(', ln.strip())
        if m:
            cur = _norm(m.group(1))
            funcs[cur] = []
        if cur:
            funcs[cur].append(_norm(ln))
            if ln.startswith('}'):
                cur = None
    return funcs


def compare(library: str, other_csrc: Path, match: str, builds: int) -> bool:
    srcs = {'this': CSRC / f'{library}.cu',
            'other': Path(other_csrc) / f'{library}.cu'}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        procs = []
        for tag, src in srcs.items():
            for i in range(builds):
                for kind, flags, ext in (
                        ('ptx', NVCC_FLAGS[:4] + ('-O3', '-ptx'), 'ptx'),
                        ('sass', NVCC_FLAGS, 'so')):
                    procs.append(subprocess.Popen(
                        [_nvcc(), *flags, '-o', str(out / f'{tag}{i}.{ext}'),
                         str(src)], stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL))
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError(f'{library}: a build failed')
        got = {(tag, kind): [read(out / f'{tag}{i}.{ext}')
                             for i in range(builds)]
               for tag in srcs for kind, read, ext in (('ptx', _ptx, 'ptx'),
                                                       ('sass', _sass, 'so'))}
    names = sorted(n for n in got['other', 'ptx'][0] if match in n)
    same_ptx = True
    for kind in ('ptx', 'sass'):
        other, this = got['other', kind], got['this', kind]
        varies = [n for n in names if any(b.get(n) != other[0][n]
                                          for b in other[1:])]
        same = [n for n in names
                if all(any(t.get(n) == o[n] for o in other) for t in this)]
        print(f'[compare] {library} {kind}, functions matching {match!r}: '
              f'{len(same)} of {len(names)} in each of {builds} builds of '
              f'this tree equal one of {builds} builds of {other_csrc}; '
              f'{len(varies)} vary between the latter\'s own builds',
              flush=True)
        for n in names:
            if n not in same:
                t, o = this[0].get(n, []), other[0][n]
                first = next((i for i, (x, y) in enumerate(zip(t, o))
                              if x != y), min(len(t), len(o)))
                print(f'[compare] {library} {kind} differs: {n}, '
                      f'{len(t)} against {len(o)} lines, from line {first}: '
                      f'{t[first:first + 2]} against {o[first:first + 2]}',
                      flush=True)
        if kind == 'ptx':
            same_ptx = len(same) == len(names) > 0
    return same_ptx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('library')
    p.add_argument('other_csrc', type=Path)
    p.add_argument('--match', default='EfE')
    p.add_argument('--builds', type=int, default=8)
    a = p.parse_args(argv)
    return 0 if compare(a.library, a.other_csrc, a.match, a.builds) else 1


if __name__ == '__main__':
    sys.exit(main())
