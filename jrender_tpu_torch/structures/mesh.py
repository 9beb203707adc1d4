"""Batched triangle mesh (counterpart of ``jrender_tpu/structures/mesh.py``).

API mirrors the reference ``jrender/structures/mesh.py``: vertices, faces
and textures with derived face_vertices, surface_normals, vertex_normals
and surface_ResNormals, ``fill_back_``/``reset_`` and
``join_meshes_as_scene``.  ``from_obj``, ``save_obj``, ``voxelize`` and the
inputs only OBJ loading produces (normal maps, TBN frames, texture
coordinates, subsurface scattering) come with the IO slice of the port.

A Mesh holds its tensors on one device, the card unless it is built with
``device='cpu'``.  Faces are int64, PyTorch's index type.
"""
from __future__ import annotations

import math
from typing import List

import torch

from .._device import resolve_device
from ..ops.segment_sum import SegmentSum, segment_order
from ..utils.math import normalize


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Gather per-face vertex coordinates: [B,V,C], [B,F,3] -> [B,F,3,C]
    (reference jrender/structures/utils/faces_vertices.py:4-19)."""
    if vertices.dim() != 3 or faces.dim() != 3:
        raise ValueError('face_vertices takes vertices [B,V,C] and faces [B,F,3]')
    b = torch.arange(vertices.shape[0], device=vertices.device)[:, None, None]
    return vertices[b, faces.long()]


def surface_normals_fn(fv: torch.Tensor) -> torch.Tensor:
    """Per-face unit normals normalize(cross(v2-v1, v0-v1)) from
    face_vertices [B,F,3,3] (reference mesh.py:214-228)."""
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    return normalize(torch.linalg.cross(v12, v10, dim=-1), axis=2, eps=1e-12)


def vertex_normals_fn(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (reference mesh.py:231-248): each face
    adds the cross product at each corner to that corner's vertex.

    The sum per vertex is ``ops.segment_sum``: each vertex adds its corners
    in ascending (face, corner) order, with no float atomics on the card,
    and its gradient is a gather; two runs give the same bits."""
    bs, nv = vertices.shape[:2]
    fv = face_vertices(vertices, faces)
    # contribution at corner k: cross(v_{k+1} - v_k, v_{k+2} - v_k)
    n = torch.stack([
        torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0], dim=-1),
        torch.linalg.cross(fv[:, :, 2] - fv[:, :, 1], fv[:, :, 0] - fv[:, :, 1], dim=-1),
        torch.linalg.cross(fv[:, :, 0] - fv[:, :, 2], fv[:, :, 1] - fv[:, :, 2], dim=-1),
    ], dim=2)                                                    # [B,F,3,3]
    offs = torch.arange(bs, device=vertices.device)[:, None, None] * nv
    order = segment_order(faces.long() + offs, bs * nv)          # corners in (b, f, k) order
    acc = SegmentSum.apply(n.reshape(-1, 3), order)
    return normalize(acc.reshape(bs, nv, 3), axis=2, eps=1e-6)


class Mesh:
    """Batched triangle mesh; see the module docstring."""

    def __init__(self, vertices, faces, textures=None, texture_res=1,
                 texture_type='surface', dr_type='softras', metallic_textures=None,
                 roughness_textures=None, device=None):
        dev = resolve_device(device)
        self.device = dev

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        vertices = f32(vertices)
        faces = torch.as_tensor(faces, device=dev).long()
        if vertices.dim() == 2:
            vertices = vertices[None]
        if faces.dim() == 2:
            faces = faces[None]

        self._vertices = vertices
        self._faces = faces
        self.texture_type = texture_type
        self.dr_type = dr_type
        self._with_specular = True
        self._fill_back = False

        bs, nv, nf = vertices.shape[0], vertices.shape[1], faces.shape[1]

        # default metallic/roughness maps (mesh.py:85-101)
        if texture_type == 'surface':
            if dr_type == 'softras':
                m_shape = (bs, nf, texture_res ** 2, 1)
            else:  # n3mr
                m_shape = (bs, nf, texture_res, texture_res, texture_res, 1)
        elif texture_type == 'vertex':
            m_shape = (bs, nv, 1)
        else:
            raise ValueError('texture type not applicable')
        self._metallic_textures = (f32(metallic_textures) if metallic_textures is not None
                                   else torch.zeros(m_shape, device=dev))
        self._roughness_textures = (f32(roughness_textures) if roughness_textures is not None
                                    else torch.ones(m_shape, device=dev))

        # textures (mesh.py:104-137)
        if textures is None:
            if texture_type == 'surface':
                if dr_type == 'softras':
                    textures = torch.ones((bs, nf, texture_res ** 2, 3), device=dev)
                else:
                    textures = torch.ones((bs, nf, texture_res, texture_res,
                                           texture_res, 3), device=dev)
                self.texture_res = texture_res
            else:
                textures = torch.ones((bs, nv, 3), device=dev)
                self.texture_res = 1
        else:
            textures = f32(textures)
            if textures.dim() == 3 and texture_type == 'surface':
                textures = textures[None]
            if textures.dim() == 2 and texture_type == 'vertex':
                textures = textures[None]
            if textures.dim() == 5:
                textures = textures[None]
            if dr_type == 'softras':
                if texture_type == 'surface':
                    self.texture_res = math.isqrt(textures.shape[2])
                else:
                    self.texture_res = 1
            else:
                self.texture_res = textures.shape[2]
        self._textures = textures

        self._origin_vertices = self._vertices
        self._origin_faces = self._faces
        self._origin_textures = self._textures

    # -- shape info ---------------------------------------------------------
    @property
    def batch_size(self):
        return self._vertices.shape[0]

    @property
    def num_vertices(self):
        return self._vertices.shape[1]

    @property
    def num_faces(self):
        return self._faces.shape[1]

    # -- core tensors -------------------------------------------------------
    @property
    def faces(self):
        return self._faces

    @faces.setter
    def faces(self, faces):
        self._faces = faces

    @property
    def vertices(self):
        return self._vertices

    @vertices.setter
    def vertices(self, vertices):
        self._vertices = vertices

    @property
    def textures(self):
        return self._textures

    @textures.setter
    def textures(self, textures):
        self._textures = textures

    @property
    def metallic_textures(self):
        return self._metallic_textures

    @metallic_textures.setter
    def metallic_textures(self, v):
        self._metallic_textures = v

    @property
    def roughness_textures(self):
        return self._roughness_textures

    @roughness_textures.setter
    def roughness_textures(self, v):
        self._roughness_textures = v

    @property
    def with_specular(self):
        return self._with_specular

    @with_specular.setter
    def with_specular(self, v):
        self._with_specular = v

    # -- derived quantities (recomputed on access) --------------------------
    @property
    def face_vertices(self):
        return face_vertices(self._vertices, self._faces)

    @property
    def surface_normals(self):
        return surface_normals_fn(self.face_vertices)

    @property
    def vertex_normals(self):
        return vertex_normals_fn(self._vertices, self._faces)

    @property
    def face_textures(self):
        if self.texture_type == 'surface':
            return self._textures
        if self.texture_type == 'vertex':
            return face_vertices(self._textures, self._faces)
        raise ValueError('texture type not applicable')

    # -- mutation helpers ---------------------------------------------------
    def fill_back_(self):
        """Duplicate faces reversed so backfaces render (mesh.py:259-263)."""
        if not self._fill_back:
            self._faces = torch.cat([self._faces, self._faces.flip(-1)], dim=1)
            self._textures = torch.cat([self._textures, self._textures], dim=1)
            self._fill_back = True

    def reset_(self):
        self._vertices = self._origin_vertices
        self._faces = self._origin_faces
        self._textures = self._origin_textures
        self._fill_back = False


def join_meshes_as_scene(meshes: List[Mesh], include_texture: bool = True) -> Mesh:
    """Concatenate meshes with vertex-index offsets (mesh.py:345-374)."""
    dev = meshes[0].device
    vert = meshes[0].vertices
    face = meshes[0].faces
    num_vertices = vert.shape[1]
    for mesh in meshes[1:]:
        vert = torch.cat([vert, mesh.vertices], dim=1)
        face = torch.cat([face, mesh.faces + num_vertices], dim=1)
        num_vertices += mesh.vertices.shape[1]
    if not include_texture:
        return Mesh(vert, face, device=dev)
    if meshes[0].textures is None:
        if any(m.textures is not None for m in meshes):
            raise ValueError('Inconsistent textures in join_meshes_as_scene.')
        return Mesh(vert, face, device=dev)
    if any(m.textures is None for m in meshes):
        raise ValueError('Inconsistent textures in join_meshes_as_scene.')
    dr_type = meshes[0].dr_type
    texture_type = meshes[0].texture_type
    if not all(dr_type == m.dr_type and texture_type == m.texture_type for m in meshes):
        raise ValueError('Inconsistent textures in join_meshes_as_scene (dr_type or texture_type).')
    tex = torch.cat([m.textures for m in meshes], dim=1)
    return Mesh(vertices=vert, faces=face, textures=tex, texture_type=texture_type,
                dr_type=dr_type, device=dev)
