"""Wavefront OBJ/MTL loading.

Counterpart of ``jrender_tpu/io/load_obj.py`` (``load_mtl`` :94,
``load_obj`` :187); the reference loaders are
  * dispatch            -- jrender/io/load_obj.py:9-21
  * softras loader      -- jrender/io/utils/_load_obj_for_softras.py:142-207
  * n3mr loader         -- jrender/io/utils/_load_obj_for_n3mr.py:7-135

Files are parsed on the host, by the native parser where it builds
(``native.objloader``) and by the Python parser below where it does not;
texture baking (``ops/texture.py``) runs on the device the caller names.
Returns tensors on that device: the card unless ``device='cpu'``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device
from ..native import objloader
from ..ops import texture as T
from ..utils.math import normalize
from .image import imread


def _parse_lines(filename_obj):
    with open(filename_obj) as f:
        return f.readlines()


def parse_vertices(lines) -> np.ndarray:
    """The Python parser's vertices [V,3] f32."""
    vs = [[float(v) for v in ln.split()[1:4]] for ln in lines
          if ln.split() and ln.split()[0] == 'v']
    return np.vstack(vs).astype(np.float32)


def parse_faces(lines) -> np.ndarray:
    """The Python parser's faces [F,3] i32, n-gons fan-triangulated."""
    faces = []
    for ln in lines:
        parts = ln.split()
        if not parts or parts[0] != 'f':
            continue
        vs = parts[1:]
        v0 = int(vs[0].split('/')[0])
        for i in range(len(vs) - 2):
            v1 = int(vs[i + 1].split('/')[0])
            v2 = int(vs[i + 2].split('/')[0])
            faces.append((v0, v1, v2))
    return np.vstack(faces).astype(np.int32) - 1


def _parse_texcoord_faces(lines):
    """(vt array [Nt,2], per-face vt index triplets, material names)."""
    vts = [[float(v) for v in ln.split()[1:3]] for ln in lines
           if ln.split() and ln.split()[0] == 'vt']
    faces = []
    material_names = []
    material_name = ''
    for ln in lines:
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == 'f':
            vs = parts[1:]

            def vt_of(tok):
                return int(tok.split('/')[1]) if ('/' in tok and '//' not in tok) else 0

            v0 = vt_of(vs[0])
            for i in range(len(vs) - 2):
                faces.append((v0, vt_of(vs[i + 1]), vt_of(vs[i + 2])))
                material_names.append(material_name)
        elif parts[0] == 'usemtl':
            material_name = parts[1]
    vts = np.vstack(vts).astype(np.float32) if vts else np.zeros((1, 2), np.float32)
    faces = np.vstack(faces).astype(np.int32) - 1
    return vts, faces, material_names


def load_mtl(filename_mtl):
    """Kd colours, map_Kd file names and the normal map's file name
    (reference _load_obj_for_softras.py:17-38)."""
    texture_filenames = {}
    normal_filename = ''
    colors = {}
    material_name = ''
    with open(filename_mtl) as f:
        for line in f.readlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'newmtl':
                material_name = parts[1]
            elif parts[0] == 'map_Kd':
                texture_filenames[material_name] = parts[1]
            elif parts[0] == 'Kd':
                colors[material_name] = np.array([float(x) for x in parts[1:4]])
            elif parts[0] == 'map_normal':
                normal_filename = parts[2]
    return colors, texture_filenames, normal_filename


def _material_mask(material_names, name, dev):
    return torch.as_tensor((np.array(material_names) == name).astype(np.int32), device=dev)


def _image(path, dev):
    return torch.as_tensor(imread(path), device=dev)


def _load_textures_softras(filename_obj, filename_mtl, texture_res, face_vertices, dev):
    lines = _parse_lines(filename_obj)
    vts, vt_faces, material_names = _parse_texcoord_faces(lines)
    fc = torch.as_tensor(vts[vt_faces], device=dev)                       # [F,3,2]

    colors, texture_filenames, normal_filename = load_mtl(filename_mtl)

    F = fc.shape[0]
    Tsz = texture_res ** 2
    textures = np.ones((F, 3), np.float32)
    for material_name, color in colors.items():
        textures[np.array(material_names) == material_name] = color
    textures = torch.as_tensor(textures, device=dev)[:, None, :].repeat(1, Tsz, 1)

    for material_name, filename_texture in texture_filenames.items():
        path = os.path.join(os.path.dirname(filename_obj), filename_texture)
        image = _image(path, dev).flip(0)
        textures = T.load_textures_softras(image, fc, textures,
                                           _material_mask(material_names, material_name, dev))

    if normal_filename == '':
        return textures, None, None, fc
    path = os.path.join(os.path.dirname(filename_obj), normal_filename)
    image = _image(path, dev)
    gray = (torch.allclose(image[..., 0], image[..., 1]) and
            torch.allclose(image[..., 1], image[..., 2]))
    if gray:
        image = T.bump_to_normal(image[..., 0])
    TBN = T.create_TBN(fc, torch.as_tensor(face_vertices, device=dev))
    normal_textures = T.load_textures_softras(
        image.flip(0), fc, torch.ones((F, Tsz, 3), device=dev),
        torch.ones((F,), dtype=torch.int32, device=dev))
    normal_textures = normalize(normal_textures * 2 - 1, axis=2)
    return textures, normal_textures, TBN, fc


def _load_textures_n3mr(filename_obj, filename_mtl, texture_res, texture_wrapping,
                        use_bilinear, dev):
    lines = _parse_lines(filename_obj)
    vts, vt_faces, material_names = _parse_texcoord_faces(lines)
    fc = torch.as_tensor(vts[vt_faces], device=dev)

    colors, texture_filenames, _ = load_mtl(filename_mtl)

    F = fc.shape[0]
    ts = texture_res
    textures = np.full((F, 3), 0.5, np.float32)
    for material_name, color in colors.items():
        textures[np.array(material_names) == material_name] = color
    textures = torch.as_tensor(textures, device=dev)[:, None, None, None, :] \
        .expand(F, ts, ts, ts, 3).contiguous()

    for material_name, filename_texture in texture_filenames.items():
        path = os.path.join(os.path.dirname(filename_obj), filename_texture)
        image = _image(path, dev).flip(0)
        textures = T.load_textures_n3mr(image, fc, textures,
                                        _material_mask(material_names, material_name, dev),
                                        T.WRAPPING[texture_wrapping], bool(use_bilinear))
    return textures


def parse_geometry(filename_obj, lines=None):
    """(vertices [V,3] f32, faces [F,3] i32) by the native parser where it
    is available, else by the Python parser (JAX ``load_obj`` :190-197)."""
    if objloader.available():
        parsed = objloader.parse_obj_native(filename_obj)
        if parsed.faces.shape[0] > 0:
            return parsed.vertices, parsed.faces
    lines = _parse_lines(filename_obj) if lines is None else lines
    return parse_vertices(lines), parse_faces(lines)


def load_obj(filename_obj, normalization=False, load_texture=False, dr_type='softras',
             texture_res=4, texture_type='surface', texture_wrapping='REPEAT',
             use_bilinear=True, device=None):
    """Load a Wavefront .obj.  Returns (vertices, faces) without textures;
    with ``load_texture``, (vertices, faces, textures, normal_textures, TBN,
    face_texcoords) for softras and (vertices, faces, textures) for n3mr.
    Faces are int64, PyTorch's index type."""
    assert dr_type in ('softras', 'n3mr')
    dev = resolve_device(device)
    lines = _parse_lines(filename_obj)
    vertices, faces = parse_geometry(filename_obj, lines)

    textures = normal_textures = TBN = face_texcoords = None
    if load_texture and texture_type == 'surface':
        for line in lines:
            if line.startswith('mtllib'):
                filename_mtl = os.path.join(os.path.dirname(filename_obj), line.split()[1])
                if dr_type == 'softras':
                    textures, normal_textures, TBN, face_texcoords = _load_textures_softras(
                        filename_obj, filename_mtl, texture_res, vertices[faces], dev)
                else:
                    textures = _load_textures_n3mr(
                        filename_obj, filename_mtl, texture_res, texture_wrapping,
                        use_bilinear, dev)
        if textures is None:
            raise Exception('Failed to load textures.')
    elif load_texture and texture_type == 'vertex':
        tex = [[float(v) for v in ln.split()[4:7]] for ln in lines
               if ln.split() and ln.split()[0] == 'v']
        textures = torch.as_tensor(np.vstack(tex).astype(np.float32), device=dev)

    # into a unit cube centred at zero (softras loader :199-203)
    if normalization:
        vertices = vertices - vertices.min(0)
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0) / 2

    vertices = torch.as_tensor(vertices, device=dev)
    faces = torch.as_tensor(faces, device=dev).long()
    if not load_texture:
        return vertices, faces
    if dr_type == 'softras':
        return vertices, faces, textures, normal_textures, TBN, face_texcoords
    return vertices, faces, textures
