"""Lighting: ambient + directional with Lambert or Cook-Torrance PBR.

Counterpart of ``jrender_tpu/lighting/lighting.py``; the reference is
  * ambient_lighting            -- jrender/renderer/lighting/ambient_lighting.py:4
  * directional_lighting + PBR  -- directional_lighting.py:5-144
    (GGX NDF :5, Schlick-GGX :21, Smith geometry :33, Schlick Fresnel :47)
  * Lighting module             -- lighting.py:159-221
  * lighting() free function    -- lighting.py:11-55
  * SSS texture-space diffusion -- lighting.py:86-156

Lights bake into the mesh textures, clamped to [0, 1], as in the
reference.  A mesh with a normal map is lit per texel; one built with
``with_SSS`` takes its textures from ``SSS``, which rasterizes the UV
layout at 2048 px through ``soft_rasterize_with_aux`` (on the card, the
binned forward kernel).
"""
from __future__ import annotations

import torch

from .._device import device_constant
from ..utils.math import normalize


def ambient_lighting(light, light_intensity=0.5, light_color=(1, 1, 1)):
    light_color = device_constant(light_color, light.device)
    if light_color.dim() == 1:
        light_color = light_color[None]
    return light + light_intensity * light_color[:, None, :]


def GGX(N, H, roughness):
    a = roughness * roughness
    a2 = a * a
    axis = 3 if N.dim() == 4 else 2
    NdotH = torch.relu((N * H).sum(dim=axis))
    NdotH2 = (NdotH * NdotH)[..., None]
    denom = NdotH2 * (a2 - 1.0) + 1.0
    denom = 3.1415 * denom * denom
    return a2 / denom


def SchlickGGX(NdotV, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    NdotV = NdotV[..., None]
    return NdotV / (NdotV * (1.0 - k) + k)


def GeometrySmith(N, V, L, roughness):
    axis = 3 if N.dim() == 4 else 2
    NdotV = torch.relu((N * V).sum(dim=axis))
    NdotL = torch.relu((N * L).sum(dim=axis))
    return SchlickGGX(NdotL, roughness) * SchlickGGX(NdotV, roughness)


def fresnelSchlick(cosTheta, F0):
    return F0 + (1.0 - F0) * ((1.0 - cosTheta) ** 5)[..., None]


def directional_lighting(diffuseLight, specularLight, normals, light_intensity=0.5,
                         light_color=(1, 1, 1), light_direction=(0, 1, 0),
                         positions=None, eye=None, with_specular=False,
                         metallic_textures=None, roughness_textures=None,
                         Gbuffer='None', transform=None):
    """Accumulate one directional light into (diffuseLight, specularLight).

    normals: [B,F,3] (surface), [B,V,3] (vertex) or [B,F,T,3] (per texel).
    """
    dev = normals.device
    light_color = device_constant(light_color, dev)
    light_direction = normalize(device_constant(light_direction, dev), axis=0)
    if eye is not None:
        eye = device_constant(eye, dev)
    if light_color.dim() == 1:
        light_color = light_color[None]
    if light_direction.dim() == 1:
        light_direction = light_direction[None]

    per_texel = normals.dim() == 4
    axis = 3 if per_texel else 2
    cosine = torch.relu((normals * light_direction).sum(dim=axis))
    if per_texel and positions is not None:
        positions = positions[:, :, None, :]

    if with_specular and not per_texel and metallic_textures is not None:
        # average texel maps down to per-face/vertex scalars (:69-84)
        if metallic_textures.dim() == 4:
            metallic_textures = metallic_textures.mean(dim=2)
            roughness_textures = roughness_textures.mean(dim=2)
        elif metallic_textures.dim() == 6:
            metallic_textures = metallic_textures.mean(dim=(2, 3, 4))
            roughness_textures = roughness_textures.mean(dim=(2, 3, 4))

    if (with_specular and eye is not None and positions is not None
            and metallic_textures is not None and roughness_textures is not None):
        N = normals
        if eye.dim() == 1:
            eye = eye[None]
        eyeb = eye[:, None, None, :] if per_texel else eye[:, None, :]
        V = normalize(eyeb - positions, axis=axis)
        L = light_direction
        H = normalize(V + L, axis=axis)

        metallic = metallic_textures
        roughness = roughness_textures
        F0 = device_constant((0.4, 0.4, 0.4), dev)
        albedo = device_constant((1.0, 1.0, 1.0), dev)
        if per_texel:
            F0 = F0[None, None, None, :] * (1 - metallic) + albedo[None, None, None, :] * metallic
            radiance = light_intensity * (light_color[:, None, None, :] * cosine[..., None])
        else:
            F0 = F0[None, None, :] * (1 - metallic) + albedo[None, None, :] * metallic
            radiance = light_intensity * (light_color[:, None, :] * cosine[..., None])

        NDF = GGX(N, H, roughness)
        G = GeometrySmith(N, V, L, roughness)
        F = fresnelSchlick(torch.relu((H * V).sum(dim=axis)), F0)
        KS = F
        KD = (1.0 - KS) * (1.0 - metallic)

        diffuseLight = diffuseLight + KD * radiance
        numerator = NDF * G * F
        denominator = (4.0 * torch.relu((N * V).sum(dim=axis)) *
                       torch.relu((N * L).sum(dim=axis)))[..., None]
        specular = numerator / denominator.clamp_min(0.01)
        specularLight = specularLight + specular * radiance
    elif per_texel:
        diffuseLight = diffuseLight + light_intensity * (
            light_color[:, None, None, :] * cosine[..., None])
    else:
        diffuseLight = diffuseLight + light_intensity * (
            light_color[:, None, :] * cosine[..., None])

    if Gbuffer == 'normal':
        specularLight = specularLight * 0.0
        diffuseLight = normals * 0.5 + 0.5
    elif Gbuffer == 'depth':
        specularLight = specularLight * 0.0
        viewpos = transform.tranpos(positions)
        zmax = viewpos[..., 2].max()
        z = viewpos[..., 2] / zmax
        diffuseLight = torch.stack([z, z, z], dim=-1)
    return [diffuseLight, specularLight]


def lighting(faces, textures, intensity_ambient=0.5, intensity_directional=0.5,
             color_ambient=(1, 1, 1), color_directional=(1, 1, 1), direction=(0, 1, 0)):
    """Free-function lighting of the n3mr path (reference lighting.py:11-55):
    faces [B,F,3,3], textures [B,F,ts,ts,ts,3]."""
    bs, nf = faces.shape[:2]
    dev = faces.device
    color_ambient = device_constant(color_ambient, dev)
    color_directional = device_constant(color_directional, dev)
    direction = device_constant(direction, dev)
    if color_ambient.dim() == 1:
        color_ambient = color_ambient[None]
    if color_directional.dim() == 1:
        color_directional = color_directional[None]
    if direction.dim() == 1:
        direction = direction[None]

    light = torch.zeros((bs, nf, 3), dtype=torch.float32, device=dev)
    if intensity_ambient != 0:
        light = light + intensity_ambient * color_ambient[:, None, :]
    if intensity_directional != 0:
        fv = faces.reshape(bs * nf, 3, 3)
        v10 = fv[:, 0] - fv[:, 1]
        v12 = fv[:, 2] - fv[:, 1]
        normals = normalize(torch.linalg.cross(v10, v12, dim=-1), eps=1e-5).reshape(bs, nf, 3)
        if direction.dim() == 2:
            direction = direction[:, None, :]
        cos = torch.relu((normals * direction).sum(dim=2))
        light = light + intensity_directional * (color_directional[:, None, :] * cos[..., None])
    light = light[:, :, None, None, None, :]
    return textures * light


class AmbientLighting:
    def __init__(self, light_intensity=0.5, light_color=(1, 1, 1)):
        self.light_intensity = light_intensity
        self.light_color = light_color

    def __call__(self, light):
        return ambient_lighting(light, self.light_intensity, self.light_color)


class DirectionalLighting:
    def __init__(self, light_intensity=0.5, light_color=(1, 1, 1),
                 light_direction=(0, 1, 0), Gbuffer='None', transform=None):
        self.light_intensity = light_intensity
        self.light_color = light_color
        self.light_direction = light_direction
        self.Gbuffer = Gbuffer
        self.transform = transform

    def __call__(self, diffuseLight, specularLight, normals, positions=None, eye=None,
                 with_specular=False, metallic_textures=None, roughness_textures=None):
        return directional_lighting(diffuseLight, specularLight, normals,
                                    self.light_intensity, self.light_color,
                                    self.light_direction, positions, eye, with_specular,
                                    metallic_textures, roughness_textures,
                                    self.Gbuffer, self.transform)


SSS_IMAGE_SIZE = 2048
SSS_BASIS = (0, 25, 100, 400)          # the Gaussians' variances, cumulative
SSS_TAPS = 7
SSS_WEIGHTS = ((0.7, 0.2, 0.1), (0.1, 0.2, 0.7), (0.1, 0.2, 0.7))   # per channel


def sss_params():
    """The UV maps' rasterizer settings (JAX lighting.py:215-218)."""
    from ..ops.softras import make_params
    return make_params(image_size=SSS_IMAGE_SIZE, background_color=(0, 0, 0), near=1,
                       far=100, fill_back=True, eps=1e-5, sigma_val=1e-5,
                       dist_func='barycentric', dist_eps=1e-5, gamma_val=1e-4,
                       aggr_func_rgb='hard', aggr_func_alpha='prod', texture_type='surface')


def sss_uv_faces(face_texcoords):
    """The UV layout as faces [B,F,9] in the rasterizer's screen space:
    (u, v) mapped to [-1, 1], depth 1.5 (JAX lighting.py:221-223)."""
    coords = (face_texcoords - 0.5) * 2
    coords = torch.cat([coords, torch.full(coords.shape[:-1] + (1,), 1.5,
                                           device=coords.device)], dim=-1)
    return coords.reshape(coords.shape[0], -1, 9)


def sss_rasterize_uv(face_texcoords, tex):
    """Rasterize per-face textures ``tex`` [B,F,T,3] over the UV layout
    ``face_texcoords`` [B,F,3,2]: one [H,W,3] map (JAX lighting.py:220-226)."""
    from ..ops.softras.api import soft_rasterize_with_aux
    out, _, _ = soft_rasterize_with_aux(sss_uv_faces(face_texcoords), tex, sss_params(),
                                        device=face_texcoords.device)
    return out[0, :3].permute(1, 2, 0)


def sss_map_textures(diffuseLight, specular, mesh):
    """The per-face textures of SSS's three UV maps: world coordinates
    (scaled to 0-255), irradiance and specular."""
    irradiance = torch.sqrt(mesh.textures * diffuseLight)
    world = (mesh.face_vertices + 1) / 2 * 255.0
    return (world.reshape(world.shape[0], world.shape[1], 3, 3), irradiance,
            specular.expand(irradiance.shape))


def sss_maps(diffuseLight, specular, mesh):
    """SSS's three UV maps [H,W,3]: world coordinates, irradiance, specular."""
    return tuple(sss_rasterize_uv(mesh.face_texcoords, t)
                 for t in sss_map_textures(diffuseLight, specular, mesh))


def sss_blur(world_map, irradiance_map):
    """The stretch-modulated Gaussian sums over the irradiance map
    (JAX lighting.py:234-256)."""
    from ..ops.image import compute_stretch_map, gaussian_blur
    stretchU, stretchV = compute_stretch_map(world_map * 7)
    stretchU = stretchU.clamp(0.0, 1.0)
    stretchV = stretchV.clamp(0.0, 1.0)
    final_map = torch.zeros_like(irradiance_map)
    for j in range(3):
        sU, sV = stretchU, stretchV
        chan = irradiance_map[:, :, j]
        for i in range(len(SSS_BASIS) - 1):
            v = SSS_BASIS[i + 1] - SSS_BASIS[i]
            sU = gaussian_blur(sU, SSS_TAPS, v, sU, 1)
            chan = gaussian_blur(chan, SSS_TAPS, v, sU, 1)
            sV = gaussian_blur(sV, SSS_TAPS, v, sV, 0)
            chan = gaussian_blur(chan, SSS_TAPS, v, sV, 0)
            final_map[:, :, j] += SSS_WEIGHTS[j][i] * chan
    return final_map


def sss_textures(final_map, mesh):
    """The diffused map resampled into the mesh's per-face texels
    (JAX lighting.py:258-263): [1,F,T,3]."""
    from ..ops.texture import load_textures_softras
    F = mesh.faces.shape[1]
    dev = final_map.device
    return load_textures_softras(final_map.flip(0), mesh.face_texcoords[0],
                                 torch.ones((F, mesh.texture_res ** 2, 3), device=dev),
                                 torch.ones((F,), dtype=torch.int32, device=dev))[None]


def SSS(diffuseLight, specular, mesh):
    """Texture-space subsurface scattering (reference lighting.py:86-156):
    the mesh's new per-face textures [1,F,T,3]."""
    world, irr, spec = sss_maps(diffuseLight, specular, mesh)
    final_map = sss_blur(world, irr) * irr + spec
    return sss_textures(final_map, mesh)


class Lighting:
    """Lighting pipeline stage (reference lighting.py:159-221).  It
    rewrites ``mesh.textures`` in place of the mesh, as the reference
    does; call ``mesh.reset_()`` before lighting a mesh again."""

    def __init__(self, light_mode='surface', intensity_ambient=0.5,
                 color_ambient=(1, 1, 1), intensity_directionals=0.5,
                 color_directionals=(1, 1, 1), directions=(0, 1, 0),
                 Gbuffer='None', transform=None):
        if light_mode not in ('surface', 'vertex'):
            raise ValueError('Lighting mode only support surface and vertex')
        self.Gbuffer = Gbuffer
        self.transform = transform
        self.light_mode = light_mode
        self.ambient = AmbientLighting(intensity_ambient, color_ambient)
        self.directionals = [DirectionalLighting(intensity_directionals,
                                                 color_directionals, directions,
                                                 Gbuffer, transform)]

    def _lights(self, mesh, shape, normals, positions, eyes):
        diffuseLight = self.ambient(torch.zeros(shape, device=mesh.textures.device))
        specularLight = torch.zeros(shape, device=mesh.textures.device)
        for directional in self.directionals:
            diffuseLight, specularLight = directional(
                diffuseLight, specularLight, normals, positions, eyes,
                mesh.with_specular, mesh.metallic_textures, mesh.roughness_textures)
        return diffuseLight, specularLight

    def surface_terms(self, mesh, eyes=None):
        """(diffuse, specular) light of surface mode: per texel [B,F,T,3]
        through a normal map, else per face [B,F,1,3]."""
        centers = mesh.face_vertices.sum(dim=2) / 3.0
        if mesh.normal_textures is not None:
            return self._lights(mesh, mesh.textures.shape, mesh.surface_ResNormals,
                                centers, eyes)
        diffuse, specular = self._lights(mesh, mesh.faces.shape, mesh.surface_normals,
                                         centers, eyes)
        return diffuse[:, :, None, :], specular[:, :, None, :]

    def __call__(self, mesh, eyes=None):
        if self.Gbuffer == 'albedo':
            return mesh
        if self.Gbuffer in ('normal', 'depth'):
            mesh.textures = torch.ones_like(mesh.textures)
        tex = mesh.textures
        if self.light_mode == 'surface':
            diffuse, specular = self.surface_terms(mesh, eyes)
            if tex.dim() == 4 and mesh.with_SSS:
                mesh.textures = SSS(diffuse, specular, mesh).clamp(0.0, 1.0)
            elif tex.dim() == 4:
                mesh.textures = (tex * diffuse + torch.ones_like(tex) * specular).clamp(0.0, 1.0)
            elif tex.dim() == 6:
                d = diffuse[:, :, None, None, ...] if diffuse.dim() == 4 \
                    else diffuse[:, :, None, None, None, :]
                s = specular[:, :, None, None, ...] if specular.dim() == 4 \
                    else specular[:, :, None, None, None, :]
                mesh.textures = (tex * d + torch.ones_like(tex) * s).clamp(0.0, 1.0)
        elif self.light_mode == 'vertex':
            diffuse, specular = self._lights(mesh, mesh.vertices.shape,
                                             mesh.vertex_normals, mesh.vertices, eyes)
            if tex.dim() == 4:
                mesh.textures = (tex * diffuse[:, :, None, :] +
                                 torch.ones_like(tex) * specular[:, :, None, :]).clamp(0.0, 1.0)
            elif tex.dim() == 3:
                # vertex textures [B,V,3]
                mesh.textures = (tex * diffuse + torch.ones_like(tex) * specular).clamp(0.0, 1.0)
            elif tex.dim() == 6:
                mesh.textures = (tex * diffuse[:, :, None, None, None, :] +
                                 torch.ones_like(tex) * specular[:, :, None, None, None, :]
                                 ).clamp(0.0, 1.0)
        return mesh
