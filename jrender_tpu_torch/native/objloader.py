"""ctypes binding of the repository's native OBJ parser (``native/objloader.cpp``).

Counterpart of ``jrender_tpu/native/objloader.py:20-122``.  The parser is
built with ``g++`` on first use into ``jrender_tpu_torch/_build/``
(git-ignored), under a name that carries a digest of the source and the
flags, as ``_build.py`` keys the CUDA libraries: an edited source is
rebuilt, a stale library never loaded.  Nothing is built at import.

``available()`` says whether the parser built and loaded here; where it
did not (no ``g++``), ``io.load_obj`` parses with its Python parser, as
the JAX package does.  ``parse_obj_native`` raises where it is not
available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'objloader.cpp'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_LOCK = threading.Lock()
_state: dict = {}          # 'lib': the loaded CDLL or None, 'error': why not


def library_path() -> Path:
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libobjloader-{h.hexdigest()[:16]}.so'


def _build_and_load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        subprocess.run(['g++', *GXX_FLAGS, str(SOURCE), '-o', str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.obj_parse_file.restype = ctypes.c_void_p
    lib.obj_parse_file.argtypes = [ctypes.c_char_p]
    for name in ('obj_num_vertices', 'obj_num_texcoords', 'obj_num_normals',
                 'obj_num_faces', 'obj_num_materials'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    for name, ct in (('obj_copy_vertices', ctypes.c_float),
                     ('obj_copy_texcoords', ctypes.c_float),
                     ('obj_copy_normals', ctypes.c_float),
                     ('obj_copy_faces', ctypes.c_int),
                     ('obj_copy_face_vt', ctypes.c_int),
                     ('obj_copy_face_vn', ctypes.c_int),
                     ('obj_copy_face_mat', ctypes.c_int)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ct)]
    lib.obj_material_name.restype = ctypes.c_char_p
    lib.obj_material_name.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.obj_mtllib.restype = ctypes.c_char_p
    lib.obj_mtllib.argtypes = [ctypes.c_void_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    with _LOCK:
        if 'lib' not in _state:
            try:
                _state['lib'] = _build_and_load()
            except (OSError, subprocess.CalledProcessError) as e:
                _state['lib'] = None
                _state['error'] = getattr(e, 'stderr', None) or str(e)
        return _state['lib']


def available() -> bool:
    """Whether the native parser builds and loads here."""
    return _lib() is not None


class ParsedObj(NamedTuple):
    vertices: np.ndarray     # [V,3] f32
    texcoords: np.ndarray    # [Nt,2] f32
    normals: np.ndarray      # [Nn,3] f32
    faces: np.ndarray        # [F,3] i32
    face_vt: np.ndarray      # [F,3] i32 (-1 when absent)
    face_vn: np.ndarray      # [F,3] i32
    face_mat: np.ndarray     # [F] i32 material id (-1 before the first usemtl)
    materials: list          # material names in id order
    mtllib: str


def parse_obj_native(path) -> ParsedObj:
    """Parse an OBJ file with the native parser."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f'the native OBJ parser is not available: {_state["error"]}')
    h = lib.obj_parse_file(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        nv, nt, nn, nf, nm = (getattr(lib, f'obj_num_{k}')(h) for k in (
            'vertices', 'texcoords', 'normals', 'faces', 'materials'))
        arrays = {'vertices': np.empty((nv, 3), np.float32),
                  'texcoords': np.empty((nt, 2), np.float32),
                  'normals': np.empty((nn, 3), np.float32),
                  'faces': np.empty((nf, 3), np.int32),
                  'face_vt': np.empty((nf, 3), np.int32),
                  'face_vn': np.empty((nf, 3), np.int32),
                  'face_mat': np.empty((nf,), np.int32)}
        for name, a in arrays.items():
            if a.size:
                ct = ctypes.c_float if a.dtype == np.float32 else ctypes.c_int
                getattr(lib, f'obj_copy_{name}')(h, a.ctypes.data_as(ctypes.POINTER(ct)))
        materials = [lib.obj_material_name(h, i).decode() for i in range(nm)]
        return ParsedObj(materials=materials, mtllib=lib.obj_mtllib(h).decode(), **arrays)
    finally:
        lib.obj_free(h)
