"""Per-material mesh chunk with lazy texture-backed maps.

Counterpart of ``jrender_tpu/scene/object.py`` (reference
jrender/Scene/objects/object.py:8-196).  An object keeps its tensors on
one device, the card unless it is built with ``device='cpu'``; its
textures are read from their files the first time they are asked for.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..ops.texture import create_TBN, load_textures_softras
from ..utils.math import normalize
from .texture import Texture


class obj:
    def __init__(self, Ka, Kd, Ke, Ns, Ni, face_vertices, face_normals_from_obj,
                 kd_texture_uv, material_name, reflection_type='diffuse',
                 map_Kd_path=None, map_normal_path=None, obj_path=None,
                 mtl_path=None, map_metallic_path=None, map_roughness_path=None,
                 map_albedo_path=None, kd_res=0, device=None):
        dev = self.device = resolve_device(device)
        self.material_name = material_name
        self._Ka = Ka
        self._Kd = Kd
        self._Ke = Ke
        self._Ns = Ns
        self._Ni = Ni
        self._roughness = 1
        self.reflection_type = reflection_type
        self.with_specular = True
        self.kd_res = kd_res

        self._albedo_textures = None
        self.albedo_textures_update = True
        self._metallic_textures = None
        self.metallic_textures_update = True
        self._roughness_textures = None
        self.roughness_textures_update = True
        self._kd_textures = None
        self.kd_textures_update = True
        self._normal_textures = None
        self.normal_textures_update = True

        self.map_Kd_path = map_Kd_path
        self.map_normal_path = map_normal_path
        self.map_albedo_path = map_albedo_path
        self.map_metallic_path = map_metallic_path
        self.map_roughness_path = map_roughness_path
        self.obj_path = obj_path
        self.mtl_path = mtl_path

        def f32(x):
            return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)

        self._face_vertices = f32(face_vertices)
        self.face_normals_from_obj = f32(face_normals_from_obj)
        self._face_normals = None
        self.face_normals_update = True
        self._kd_texture_uv = f32(kd_texture_uv)
        self._face_kd = None
        self.face_kd_update = True
        self._surface_normals = None
        self.surface_normals_update = True
        self.Generate_Normals = 'surface'

    @property
    def face_vertices(self):
        return self._face_vertices

    @property
    def surface_normals(self):
        if self.surface_normals_update:
            if self.normal_textures is None:
                v10 = self._face_vertices[:, 0] - self._face_vertices[:, 1]
                v12 = self._face_vertices[:, 2] - self._face_vertices[:, 1]
                self._surface_normals = normalize(torch.linalg.cross(v12, v10, dim=-1), axis=1)
            self.surface_normals_update = False
        return self._surface_normals

    @property
    def face_normals(self):
        if self.face_normals_update:
            if self.Generate_Normals == 'surface':
                self._face_normals = torch.ones_like(self._face_vertices) * \
                    self.surface_normals[:, None, :]
            elif self.Generate_Normals == 'normal_texture':
                normals = self.normal_textures.query_uv
                TBN = create_TBN(self._kd_texture_uv, self._face_vertices)
                self._face_normals = torch.matmul(normals[:, :, None, :],
                                                  TBN[:, None])[:, :, 0, :]
            elif self.Generate_Normals == 'from_obj':
                self._face_normals = normalize(self.face_normals_from_obj, axis=2)
            self.face_normals_update = False
        return self._face_normals

    def _lazy_texture(self, attr, path_attr):
        flag = attr + '_update'
        if getattr(self, flag):
            setattr(self, '_' + attr, Texture.from_path(getattr(self, path_attr),
                                                        device=self.device))
            setattr(self, flag, False)
        return getattr(self, '_' + attr)

    @property
    def metallic_textures(self):
        return self._lazy_texture('metallic_textures', 'map_metallic_path')

    @property
    def roughness_textures(self):
        return self._lazy_texture('roughness_textures', 'map_roughness_path')

    @property
    def albedo_textures(self):
        return self._lazy_texture('albedo_textures', 'map_albedo_path')

    @property
    def normal_textures(self):
        return self._lazy_texture('normal_textures', 'map_normal_path')

    @property
    def kd_textures(self):
        if self.kd_textures_update:
            self._kd_textures = Texture.from_path(self.map_Kd_path, device=self.device)
            if self._kd_textures is not None:
                self._kd_textures.image = self._kd_textures.image.flip(0)
            self.kd_textures_update = False
        return self._kd_textures

    def _face_map(self, texture, default):
        if texture is not None:
            texture.uv = self._kd_texture_uv
            return texture.query_uv
        return default

    @property
    def face_albedo(self):
        return self._face_map(self.albedo_textures, torch.ones_like(self._face_vertices))

    @property
    def face_metallic(self):
        F = self._face_vertices.shape[0]
        return self._face_map(self.metallic_textures,
                              torch.zeros((F, 3, 1), device=self.device))

    @property
    def face_roughness(self):
        F = self._face_vertices.shape[0]
        return self._face_map(self.roughness_textures,
                              torch.ones((F, 3, 1), device=self.device) * self._roughness)

    @property
    def specular(self):
        v = 1.0 if self.with_specular else 0.0
        return torch.full((self._face_vertices.shape[0], 3, 1), v, device=self.device)

    @property
    def face_kd(self):
        if self.face_kd_update:
            F = self._face_vertices.shape[0]
            if self.kd_textures is not None:
                if self.kd_res == 0:
                    self.kd_textures.uv = self._kd_texture_uv
                    self._face_kd = self.kd_textures.query_uv
                else:
                    self._face_kd = load_textures_softras(
                        self.kd_textures.image, self._kd_texture_uv,
                        torch.ones((F, self.kd_res, 3), device=self.device),
                        torch.ones((F,), dtype=torch.int32, device=self.device))
            else:
                kd = torch.as_tensor(self._Kd if self._Kd is not None else (1, 1, 1),
                                     dtype=torch.float32, device=self.device)
                if self.kd_res == 0:
                    self._face_kd = torch.ones_like(self._face_vertices) * kd
                else:
                    self._face_kd = torch.ones((F, self.kd_res, 3), device=self.device) * kd
            self.face_kd_update = False
        return self._face_kd

    def set_vertices(self, transform):
        self._face_vertices = transform(self._face_vertices)
        self._face_normals = transform(self._face_normals)

    def rescaling(self, scale):
        mx = self._face_vertices.amax(dim=(0, 1), keepdim=True)
        mn = self._face_vertices.amin(dim=(0, 1), keepdim=True)
        center = (mx + mn) / 2
        s = (mx - mn).max() / scale / 2
        self._face_vertices = (self._face_vertices - center) / s
        self.face_normals_update = True
        self.surface_normals_update = True
