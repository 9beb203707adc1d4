"""Builds the package's CUDA sources into shared libraries bound with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers), which takes seconds.  A library is built on
first use into ``jrender_tpu_torch/_build/`` (git-ignored), under a name
that carries a digest of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  ``-Xptxas -v`` is on: the
compiler's register, shared-memory and spill report of each build is kept
beside the library (``<lib>.log``).

A build may set preprocessor macros (``defines``, such as
``(('SOFTRAS_FWD_SPLIT', 8),)``): a variant of a kernel with another
compile-time constant, built beside the default one under its own name,
for a tool that times the alternatives.  The package itself loads the
default builds only.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on the PATH."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and (Path(home) / 'bin' / 'nvcc').exists():
            return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built '
                           '(set CUDA_HOME or put nvcc on the PATH)')
    return found


def _flags(defines=()) -> list[str]:
    return [*NVCC_FLAGS, *(f'-D{k}={v}' for k, v in defines)]


def library_path(name: str, defines=()) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the digest covers the source,
    every header in csrc/ and the flags, macros included."""
    h = hashlib.sha256(' '.join(_flags(defines)).encode())
    for src in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(names) -> dict:
    """Build the named sources that are not built yet, one nvcc process
    each, all started together.  A name may be a pair (name, defines) to
    build with macros of its own.  Returns each (name, defines)'s library.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    specs = [n if isinstance(n, tuple) else (n, ()) for n in names]
    procs = {}
    for name, defs in specs:
        out = library_path(name, defs)
        if out.exists() or out in procs:
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *_flags(defs), '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[out] = (name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for out, (name, proc, tmp) in procs.items():
        log, _ = proc.communicate()
        Path(f'{out}.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exit {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return {spec: library_path(*spec) for spec in specs}


def build_log(name: str, defines=()) -> str:
    """The compiler's output for the current build of ``name``."""
    log = Path(f'{library_path(name, defines)}.log')
    return log.read_text() if log.exists() else ''


def load(name: str, defines=()) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu`` (built with ``defines``),
    built on first use."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        path = build([key])[key]
        lib = _loaded[key] = ctypes.CDLL(str(path))
    return lib
