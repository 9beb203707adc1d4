"""Deferred G-buffer renderer.

Counterpart of ``jrender_tpu/scene/render.py`` (reference
jrender/render2/render2.py:18-494).  Built on SoftRas's hard mode
(``dist_func='barycentric'``, ``aggr_func_rgb='hard'``): it rasterizes
per-face attributes into normal, world, KD, albedo and
metallic-roughness buffers, shades each light (Blinn-Phong or
Cook-Torrance) with its shadow visibility (PCF over depth maps, VSSM for
area lights), then applies SSSR, SSR, a clamp and FXAA.

Every rasterization goes through ``soft_rasterize_with_aux`` on the
renderer's device: on the card the route that ``ops/softras/route.py``
picks (by default the binned forward kernel), on the CPU its plain
version.  The face-id buffer is the hard aggregate's winner
(``aggrs[0, 1]``), -1 where no face covers a pixel.

Random draws: SSAO, SSDO and SSSR draw from a ``torch.Generator`` on the
device seeded 0 (``ops.image``), unless given their uniform draws:
``sssr_samples`` [spp, 2, H, W], where set, for SSSR inside
``fragment_shader``, and ``samples`` [sample_num, 3] for ``SSAO`` and
``SSDO``.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .._device import resolve_device
from ..lighting.lighting import GGX, GeometrySmith, fresnelSchlick
from ..ops import image as I
from ..ops.softras import make_params
from ..ops.softras.api import soft_rasterize_with_aux
from ..transform import Transform
from ..utils.angles import get_points_from_angles
from ..utils.math import normalize
from .light import Light
from .texture import Texture


class Render:
    def __init__(self, image_size=256, background_color=(0, 0, 0), near=0.1,
                 far=100, camera_mode='look', K=None, R=None, t=None,
                 dist_coeffs=None, orig_size=512, perspective=True,
                 viewing_angle=30, viewing_scale=1.0, eye=None,
                 camera_direction=(0, 0, 1), threshold=2e-2, up=(0, 1, 0),
                 MSAA=False, bin_size=0, max_elems_per_bin=0,
                 ssr_mode='naive', device=None):
        self.device = resolve_device(device)
        self.transform = Transform(camera_mode, K, R, t, dist_coeffs, orig_size,
                                   perspective, viewing_angle, viewing_scale,
                                   eye, camera_direction)
        self.eye = eye
        self.camera_direction = camera_direction
        self.viewing_angle = viewing_angle
        self.viewing_scale = viewing_scale
        self.camera_mode = camera_mode
        self.perspective = perspective
        self.up = up
        self.near = near
        self.far = far
        self.fill_back = True
        self.threshold = threshold
        assert ssr_mode in ('naive', 'hiz')
        self.ssr_mode = ssr_mode

        self._world_buffer = None
        self._normal_buffer = None
        self._KD_buffer = None
        self._faces_ind_buffer = None
        self._proj_vertices = None
        self.world_buffer_update = True
        self.normal_buffer_update = True
        self.KD_buffer_update = True
        self.proj_vertices_update = True

        self.MRT = None
        self.GeometryDesc = None
        self.MaterialDesc = None
        self.IlluminationDesc = None
        self.lights_transform = True
        self._lights = None

        self._albedo_buffer = None
        self.albedo_buffer_update = True
        self._metallic_roughness_buffer = None
        self.metallic_roughness_buffer_update = True

        self.texture_type = 'vertex'
        self.image_size = image_size
        self.background_color = background_color
        self.MSAA = MSAA
        self._last_aggrs = None
        self.sssr_samples = None

    def _vec(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @property
    def width(self):
        """tan of the viewing angle: the image plane's half width at depth 1."""
        return math.tan(self.viewing_angle / 180.0 * math.pi)

    # -- camera helpers -----------------------------------------------------
    def set_eyes_from_angles(self, distances, elevations, azimuths):
        self.eye = get_points_from_angles(distances, elevations, azimuths)

    def view_rotate_m(self):
        if self.camera_mode == 'look':
            z = normalize(self._vec(self.camera_direction)[None], eps=1e-5)
        else:  # look_at
            z = -normalize(self._vec(self.eye)[None], eps=1e-5)
        x = normalize(torch.linalg.cross(self._vec(self.up)[None], z, dim=-1), eps=1e-5)
        y = normalize(torch.linalg.cross(z, x, dim=-1), eps=1e-5)
        return torch.cat([x, y, z], 0).T

    def vp_transform(self, vertices, eye=None, camera_direction=None,
                     viewing_angle=None, viewing_scale=None, camera_mode=None,
                     perspective=None, up=None):
        if len(vertices) == 0:
            return torch.zeros((0,), device=self.device)
        t = Transform(eye=eye if eye is not None else self.eye,
                      camera_direction=camera_direction if camera_direction is not None
                      else self.camera_direction,
                      viewing_angle=viewing_angle if viewing_angle is not None
                      else self.viewing_angle,
                      viewing_scale=viewing_scale if viewing_scale is not None
                      else self.viewing_scale,
                      camera_mode=camera_mode if camera_mode is not None else self.camera_mode,
                      perspective=perspective if perspective is not None else self.perspective,
                      up=up if up is not None else self.up)
        return t.tranpos(vertices)

    # -- rasterization ------------------------------------------------------
    def raster_params(self, MSAA=False, fill_back=True, texture_type='vertex'):
        """The rasterizer's settings of ``Rasterize``: hard rgb, barycentric
        distance."""
        return make_params(image_size=self.image_size * (2 if MSAA else 1),
                           background_color=tuple(self.background_color),
                           near=self.near, far=self.far, fill_back=fill_back,
                           dist_func='barycentric', aggr_func_rgb='hard',
                           texture_type=texture_type)

    def Rasterize(self, face_proj, face_info, MSAA=False, fill_back=True,
                  texture_type='vertex'):
        """Hard-mode rasterization of per-face attributes -> [H,W,3]; the
        aggregates (depth, winner id) are kept in ``_last_aggrs``."""
        if len(face_info) == 0:
            return torch.zeros((0,), device=self.device)
        p = self.raster_params(MSAA, fill_back, texture_type)
        F = face_proj.shape[0]
        fv = face_proj.reshape(1, F, 9)
        tex = face_info.reshape((1, F) + tuple(face_info.shape[1:]))
        out, aggrs, _ = soft_rasterize_with_aux(fv, tex, p, device=self.device)
        if MSAA:
            B, C, H, W = out.shape
            out = out.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))
            aggrs = aggrs[:, :, ::2, ::2]
        self._last_aggrs = aggrs
        return out[0, :3].permute(1, 2, 0)

    # -- lights -------------------------------------------------------------
    @property
    def lights(self):
        if self.IlluminationDesc.light_update:
            self._lights = copy.deepcopy(self.IlluminationDesc.lights)
            self.lights_transform = True
        if self.lights_transform:
            rot = self.view_rotate_m()
            eye = self._vec(self.eye)[None]
            for light in self._lights:
                if light.shadow:
                    light.DepthMap = Texture(self.generate_DepthMap(light), device=self.device)
                light.direction = torch.matmul(self._vec(light.direction)[None], rot)[0].tolist()
                light.position = torch.matmul(self._vec(light.position)[None] - eye,
                                              rot)[0].tolist()
                light.up = torch.matmul(self._vec(light.up)[None], rot)[0].tolist()
            self.lights_transform = False
            self.IlluminationDesc.light_update = False
        return self._lights

    def generate_DepthMap(self, light: Light):
        fv = self.MRT.worldcoords
        if light.type in ('point', 'area'):
            proj = self.vp_transform(vertices=fv, eye=light.position,
                                     camera_direction=light.direction,
                                     viewing_angle=light.viewing_angle,
                                     camera_mode='look', perspective=True, up=light.up)
            self.Rasterize(proj, proj, fill_back=light.fillback)
            DM = self._last_aggrs[0, 0]
            return torch.where(DM > light.far, light.far + 1, DM)
        if light.type == 'directional':
            proj = self.vp_transform(vertices=fv, eye=light.position,
                                     camera_direction=light.direction,
                                     viewing_scale=light.viewing_scale,
                                     camera_mode='look', perspective=False, up=light.up)
            DM = self.Rasterize(proj, proj, fill_back=light.fillback)[:, :, 2]
            return torch.where(DM > light.far, light.far + 1, DM)
        return None

    def light_visibility(self, light: Light):
        if light.type == 'ambient' or not light.shadow:
            return 1
        if light.type == 'directional':
            proj = self.vp_transform(vertices=self.world_buffer, eye=light.position,
                                     camera_direction=light.direction,
                                     viewing_scale=light.viewing_scale,
                                     perspective=False, camera_mode='look', up=light.up)
            bias = 0.04
        else:
            proj = self.vp_transform(vertices=self.world_buffer, eye=light.position,
                                     camera_direction=light.direction,
                                     viewing_angle=light.viewing_angle,
                                     perspective=True, camera_mode='look', up=light.up)
            bias = 0.02
        eyeDepth = proj[:, :, 2]
        uv = torch.stack([(proj[:, :, 0] + 1) / 2, 1 - (proj[:, :, 1] + 1) / 2], 2)
        light.DepthMap.uv = uv
        if light.type == 'area':
            DM = light.DepthMap.image
            SAT = Texture.generate_SAT(DM)
            SAT2 = Texture.generate_SAT(DM * DM)
            return I.VSSM(eyeDepth, SAT, SAT2, uv, light)[..., None]
        LightDepth = light.DepthMap.query_uv
        shading = ((eyeDepth - LightDepth) < bias).float()[..., None]
        filter_w = torch.ones((7, 7), device=self.device) / 49
        return I.conv_for_image(shading, filter_w, 1)

    # -- G-buffers ----------------------------------------------------------
    @property
    def proj_vertices(self):
        if self.proj_vertices_update or self.GeometryDesc.proj_v_update:
            self._proj_vertices = self.vp_transform(self.MRT.worldcoords)
            self.proj_vertices_update = False
            self.GeometryDesc.proj_v_update = False
        return self._proj_vertices

    def _view_normals(self):
        return torch.matmul(self.MRT.normals[:, :, None, :], self.view_rotate_m())[:, :, 0, :]

    @property
    def world_buffer(self):
        if self.world_buffer_update or self.GeometryDesc.wcoord_update:
            self._normal_buffer = self.Rasterize(self.proj_vertices, self._view_normals())
            aggrs = self._last_aggrs
            z = aggrs[0, 0]
            self._faces_ind_buffer = aggrs[0, 1].to(torch.int64)
            is_ = self.image_size
            x = ((2 * torch.arange(is_, dtype=torch.float32, device=self.device) + 1)
                 / is_ - 1).repeat(is_, 1)
            y = x.flip(1).T
            width = self.width
            self._world_buffer = torch.stack([x * z * width, y * z * width, z], 2)
            self.normal_buffer_update = False
            self.world_buffer_update = False
            self.GeometryDesc.wcoord_update = False
            self.GeometryDesc.normal_update = False
        return self._world_buffer

    @property
    def normal_buffer(self):
        if self.normal_buffer_update or self.GeometryDesc.normal_update:
            self._normal_buffer = self.Rasterize(self.proj_vertices, self._view_normals())
            self.normal_buffer_update = False
            self.GeometryDesc.normal_update = False
        return self._normal_buffer

    @property
    def KD_buffer(self):
        if self.KD_buffer_update or self.MaterialDesc.KD_update:
            self._KD_buffer = self.Rasterize(self.proj_vertices, self.MRT.KD,
                                             texture_type='surface')
            self.KD_buffer_update = False
            self.MaterialDesc.KD_update = False
        return self._KD_buffer

    @property
    def albedo_buffer(self):
        if not self.MaterialDesc.PBR:
            return self._albedo_buffer
        if self.albedo_buffer_update or self.MaterialDesc.albedo_update:
            self._albedo_buffer = self.Rasterize(self.proj_vertices, self.MRT.albedo)
            self.albedo_buffer_update = False
            self.MaterialDesc.albedo_update = False
        return self._albedo_buffer

    @property
    def metallic_roughness_buffer(self):
        if not self.MaterialDesc.PBR:
            return self._metallic_roughness_buffer
        if self.metallic_roughness_buffer_update or \
                self.MaterialDesc.metallic_roughness_update:
            self._metallic_roughness_buffer = self.Rasterize(
                self.proj_vertices, self.MRT.metallic_roughness)
            self.metallic_roughness_buffer_update = False
            self.MaterialDesc.metallic_roughness_update = False
        return self._metallic_roughness_buffer

    @property
    def faces_ind_buffer(self):
        return self._faces_ind_buffer

    # -- shading ------------------------------------------------------------
    def fragment_shader(self):
        worldcoords = self.world_buffer
        N = self.normal_buffer
        color = torch.zeros_like(worldcoords)
        textures = self.KD_buffer

        for light in self.lights:
            light_color = self._vec(light.color)
            if light.type == 'ambient':
                color = color + light.intensity * light_color[None, None] * textures
                continue

            V = normalize(-worldcoords, axis=2)
            if light.type == 'directional':
                L = -normalize(self._vec(light.direction), axis=0)[None, None]
            else:  # point / area
                L = normalize(self._vec(light.position) - worldcoords, axis=2)
            H = normalize(V + L, axis=2)
            cosine = torch.relu((L * N).sum(2))[..., None]
            shading = self.light_visibility(light)

            if self.IlluminationDesc.shading == 'blinn_phong':
                Ns = 15
                diffuse = light.intensity * light_color[None, None] * cosine
                specular = (torch.relu((H * N).sum(2)) ** Ns)[..., None] * \
                    light_color[None, None]
                color = color + (diffuse + specular) * textures * shading
            elif self.IlluminationDesc.shading == 'Cook_Torrance':
                F0 = self._vec((0.04, 0.04, 0.04))
                albedo = self.albedo_buffer
                metallic = self.metallic_roughness_buffer[:, :, 0:1]
                roughness = self.metallic_roughness_buffer[:, :, 1:2]
                with_specular = self.metallic_roughness_buffer[:, :, 2:3]
                F0 = F0 * (1 - metallic) + albedo * metallic
                radiance = light.intensity * (light_color[None, None] * cosine)

                NDF = GGX(N[None], H[None], roughness[None])[0]
                G = GeometrySmith(N[None], V[None], L[None] if L.dim() == 3 else
                                  L.expand(N.shape)[None], roughness[None])[0]
                Fr = fresnelSchlick(torch.relu((H * V).sum(2))[None], F0[None])[0]
                KD = (1.0 - Fr) * (1.0 - metallic)
                diffuse = KD * radiance * shading
                numerator = NDF * G * Fr
                denominator = (4.0 * torch.relu((N * V).sum(2)) *
                               torch.relu((N * L).sum(2)))[..., None]
                specular = numerator / denominator.clamp_min(0.01) * \
                    radiance * shading * with_specular
                color = color + diffuse * textures + specular

        color = self.SSSR(color)
        color = self.SSR(color)
        color = color.clamp(0, 1)
        return I.FXAA(color)

    # -- screen-space effects ----------------------------------------------
    def _reflective_ranges(self, reflection_type):
        faces = []
        for o in self.MaterialDesc.objects:
            if o.reflection_type == reflection_type:
                i = self.GeometryDesc.name_dic[o.material_name]
                faces += self.GeometryDesc.obj_faces[f'{i}']
        return faces

    def SSR(self, color):
        ssr_faces = self._reflective_ranges('mirror')
        if len(ssr_faces) == 0:
            return color
        ssr_faces = np.asarray(ssr_faces, np.int64)
        if self.ssr_mode == 'hiz':
            # the mipmap-accelerated march (reference SSR_cuda variant,
            # SSR_cuda.py:260); needs a power-of-two image size
            return I.SSR_hiz(color, self.world_buffer, self.normal_buffer,
                             self.faces_ind_buffer, ssr_faces, self.width, self.far)
        return I.SSR(color, self.world_buffer, self.normal_buffer, self.faces_ind_buffer,
                     ssr_faces, self.width, self.far, step=1)

    def SSSR(self, color, spp=32):
        ssr_faces = self._reflective_ranges('glossy')
        if len(ssr_faces) == 0:
            return color
        rough = self.metallic_roughness_buffer[:, :, 1:2]
        reflect = I.SSSR(color, self.world_buffer, self.normal_buffer, rough,
                         self.faces_ind_buffer, np.asarray(ssr_faces, np.int64),
                         self.width, self.far, spp=spp, samples=self.sssr_samples)
        reflect = I.bilateral_filter(reflect.clamp(0, 1))
        return color + reflect

    def SSAO(self, color, sample_num=256, sample_range_r=0.25, samples=None):
        depth = self.world_buffer[:, :, 2]
        occ = I.SSAO(depth, self.faces_ind_buffer, self.normal_buffer, self.width,
                     sample_num=sample_num, sample_range_r=sample_range_r,
                     samples=samples)
        ambient = 1 - occ
        filter_w = torch.ones((5, 5), device=self.device) / 25
        ambient = I.conv_for_image(ambient, filter_w, 0)
        return color * ambient[..., None]

    def SSDO(self, color, sample_num=1024, sample_range_r=0.3, samples=None):
        depth = self.world_buffer[:, :, 2]
        return I.SSDO(color, depth, self.faces_ind_buffer, self.normal_buffer, self.width,
                      sample_num=sample_num, sample_range_r=sample_range_r,
                      samples=samples)
