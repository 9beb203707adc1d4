"""What both configurations share: the mesh, the camera, the lighting, the
transform and Adam, in plain PyTorch.

Frozen copies, one operation at a time in the port's order, of
``bench.py`` ``uv_sphere`` (:94), ``jrender_tpu_torch/utils/angles.py``
``get_points_from_angles``, ``structures/mesh.py`` (``face_vertices``,
``surface_normals_fn``), ``lighting/lighting.py`` (``Lighting`` in surface
mode with the directional light's Cook-Torrance terms, as ``Renderer``'s
defaults and a ``Mesh``'s default metallic 0 and roughness 1 give them),
``transform/functional.py`` (``look_at``, ``perspective``) and
``torch.optim.Adam``'s update.  Every function works in the dtype of its
inputs, so the lower-precision control runs the same code in bfloat16.
"""
from __future__ import annotations

import math

import torch


def uv_sphere(rings: int, segs: int, radius: float, device=None):
    """``bench.py``'s UV sphere: vertices [V,3] float32 (worked out in
    float64, as numpy does there) and faces [F,3] int64, in its order."""
    r = torch.arange(rings + 1, dtype=torch.float64, device=device)[:, None]
    s = torch.arange(segs, dtype=torch.float64, device=device)[None, :]
    phi = math.pi * r / rings
    th = 2 * math.pi * s / segs
    v = torch.stack([torch.sin(phi) * torch.cos(th) * radius,
                     (torch.cos(phi) * radius).expand(-1, segs),
                     torch.sin(phi) * torch.sin(th) * radius], -1)
    ri = torch.arange(rings, device=device)[:, None]
    si = torch.arange(segs, device=device)[None, :]
    a = ri * segs + si
    b = ri * segs + (si + 1) % segs
    c = (ri + 1) * segs + si
    d = (ri + 1) * segs + (si + 1) % segs
    tris = torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, c], -1)], 2)
    keep = torch.stack([ri[:, 0] > 0, ri[:, 0] < rings - 1], 1)          # [rings, 2]
    keep = keep[:, None, :].expand(-1, segs, -1)
    return v.reshape(-1, 3).to(torch.float32), tris[keep].reshape(-1, 3)


def eyes_from_angles(distance: float, elevation: float, azimuths: torch.Tensor):
    """Eye positions [N,3] of the look-at camera, angles in degrees."""
    el = torch.deg2rad(torch.full_like(azimuths, elevation))
    az = torch.deg2rad(azimuths)
    d = torch.full_like(azimuths, distance)
    return torch.stack(torch.broadcast_tensors(
        d * torch.cos(el) * torch.sin(az), d * torch.sin(el),
        -d * torch.cos(el) * torch.cos(az)), dim=-1)


def normalize(x, axis=-1, eps=1e-12):
    return x / torch.linalg.vector_norm(x, dim=axis, keepdim=True).clamp_min(eps)


def face_vertices(vertices, faces):
    """[B,V,C], [B,F,3] -> [B,F,3,C]."""
    b = torch.arange(vertices.shape[0], device=vertices.device)[:, None, None]
    return vertices[b, faces]


def surface_normals(fv):
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    return normalize(torch.linalg.cross(v12, v10, dim=-1), axis=2, eps=1e-12)


def face_light(fv, eyes, ambient=0.5, directional=0.5, direction=(0.0, 1.0, 0.0)):
    """(diffuse, specular) [B,F,3] of a face: the ambient light and one
    white directional light with the Cook-Torrance terms at metallic 0 and
    roughness 1 (``directional_lighting`` with ``with_specular``)."""
    dt, dev = fv.dtype, fv.device
    B, F = fv.shape[:2]
    normals = surface_normals(fv)
    centers = fv.sum(dim=2) / 3.0
    color = torch.ones((1, 3), dtype=dt, device=dev)
    ld = normalize(torch.tensor(direction, dtype=dt, device=dev), axis=0)[None]
    diffuse = torch.zeros((B, F, 3), dtype=dt, device=dev) + ambient * color[:, None, :]
    specular = torch.zeros((B, F, 3), dtype=dt, device=dev)
    cosine = torch.relu((normals * ld).sum(dim=2))
    metallic = torch.zeros((B, F, 1), dtype=dt, device=dev)
    roughness = torch.ones((B, F, 1), dtype=dt, device=dev)
    N = normals
    V = normalize(eyes[:, None, :] - centers, axis=2)
    L = ld
    H = normalize(V + L, axis=2)
    F0 = torch.tensor((0.4, 0.4, 0.4), dtype=dt, device=dev)[None, None, :] * (1 - metallic) \
        + torch.ones(3, dtype=dt, device=dev)[None, None, :] * metallic
    radiance = directional * (color[:, None, :] * cosine[..., None])
    a = roughness * roughness
    a2 = a * a
    NdotH = torch.relu((N * H).sum(dim=2))
    denom = (NdotH * NdotH)[..., None] * (a2 - 1.0) + 1.0
    NDF = a2 / (3.1415 * denom * denom)

    def schlick(ndot):
        r = roughness + 1.0
        k = (r * r) / 8.0
        ndot = ndot[..., None]
        return ndot / (ndot * (1.0 - k) + k)

    NdotV = torch.relu((N * V).sum(dim=2))
    NdotL = torch.relu((N * L).sum(dim=2))
    G = schlick(NdotL) * schlick(NdotV)
    cos_hv = torch.relu((H * V).sum(dim=2))
    Fr = F0 + (1.0 - F0) * ((1.0 - cos_hv) ** 5)[..., None]
    KD = (1.0 - Fr) * (1.0 - metallic)
    diffuse = diffuse + KD * radiance
    denominator = (4.0 * torch.relu((N * V).sum(dim=2)) * torch.relu((N * L).sum(dim=2)))[..., None]
    spec = NDF * G * Fr / denominator.clamp_min(0.01)
    specular = specular + spec * radiance
    return diffuse, specular


def lit_textures(textures, diffuse, specular):
    """Textures [B,F,T,3] or [B,F,ts,ts,ts,3] under per-face light [B,F,3]."""
    shape = (diffuse.shape[0], diffuse.shape[1]) + (1,) * (textures.dim() - 3) + (3,)
    d, s = diffuse.reshape(shape), specular.reshape(shape)
    return (textures * d + torch.ones_like(textures) * s).clamp(0.0, 1.0)


def look_at(vertices, eyes):
    """Camera frames looking from ``eyes`` [B,3] at the origin, y up."""
    B, dt, dev = vertices.shape[0], vertices.dtype, vertices.device
    at = torch.zeros((B, 3), dtype=dt, device=dev)
    up = torch.tensor((0.0, 1.0, 0.0), dtype=dt, device=dev).expand(B, 3)
    z = normalize(at - eyes, eps=1e-5)
    x = normalize(torch.linalg.cross(up, z, dim=-1), eps=1e-5)
    y = normalize(torch.linalg.cross(z, x, dim=-1), eps=1e-5)
    r = torch.stack([x, y, z], dim=1)
    return torch.matmul(vertices - eyes[:, None, :], r.transpose(1, 2))


def perspective(vertices, angle=30.0):
    width = torch.tan(torch.tensor(angle, dtype=vertices.dtype, device=vertices.device)
                      / 180.0 * math.pi)
    z = vertices[..., 2]
    return torch.stack([vertices[..., 0] / z / width, vertices[..., 1] / z / width, z], dim=-1)


def lit_and_projected(vertices, faces, textures, eyes, viewing_angle=30.0):
    """The lighting and the transform of ``Renderer.render_mesh`` (light
    in world space first, then the look-at camera and the perspective):
    (face vertices [B,F,3,3] on screen, lit textures)."""
    fv = face_vertices(vertices, faces)
    diffuse, specular = face_light(fv, eyes)
    tex = lit_textures(textures, diffuse, specular)
    screen = perspective(look_at(vertices, eyes), viewing_angle)
    return face_vertices(screen, faces), tex


class Adam:
    """``torch.optim.Adam``'s update (no weight decay, no amsgrad), one
    group of settings per leaf: state after step t is what the program's
    optimizer holds after its step t."""

    def __init__(self, leaves, settings, eps=1e-8):
        self.leaves = leaves
        self.settings = settings
        self.eps = eps
        self.t = 0
        self.m = [torch.zeros_like(x) for x in leaves]
        self.v = [torch.zeros_like(x) for x in leaves]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        for x, g, m, v, (lr, (b1, b2)) in zip(self.leaves, grads, self.m, self.v, self.settings):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1 = 1 - b1 ** self.t
            bc2 = 1 - b2 ** self.t
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            x.addcdiv_(m, denom, value=-lr / bc1)
