"""Camera / projection transforms (plain PyTorch).

Counterpart of ``jrender_tpu/transform/functional.py``; the reference
transforms are
  * look_at      -- jrender/renderer/transform/look_at.py:3
  * look         -- jrender/renderer/transform/look.py:3
  * perspective  -- jrender/renderer/transform/perspective.py:4
  * orthogonal   -- jrender/renderer/transform/orthogonal.py:3
  * projection   -- jrender/renderer/transform/projection.py:3 (OpenCV distortion)

All functions take and return float32 ``[B, N, 3]`` vertex tensors.  A
constant given as a Python value goes to the vertices' device once
(``device_constant``); one given as a tensor is used as it is.
"""
from __future__ import annotations

import math

import torch

from .._device import device_constant
from ..utils.math import normalize


def _as_batched_vec3(x, batch_size: int, device) -> torch.Tensor:
    v = device_constant(x, device)
    if v.dim() == 1:
        v = v.expand(batch_size, 3)
    return v


def _frame(vertices, eye, x_axis, y_axis, z_axis):
    # rows of r are the new basis: [B, 3, 3]
    r = torch.stack([x_axis, y_axis, z_axis], dim=1)
    if eye.dim() == 2:
        eye = eye[:, None, :]
    return torch.matmul(vertices - eye, r.transpose(1, 2))


def look_at(vertices: torch.Tensor, eye, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """Rotate/translate vertices into a camera frame looking from ``eye``
    to ``at`` (reference look_at.py:3-41)."""
    if vertices.dim() != 3:
        raise ValueError('vertices must have shape [B, N, 3]')
    bs, dev = vertices.shape[0], vertices.device
    eye = _as_batched_vec3(eye, bs, dev)
    at = _as_batched_vec3(at, bs, dev)
    up = _as_batched_vec3(up, bs, dev)

    z_axis = normalize(at - eye, eps=1e-5)
    x_axis = normalize(torch.linalg.cross(up, z_axis, dim=-1), eps=1e-5)
    y_axis = normalize(torch.linalg.cross(z_axis, x_axis, dim=-1), eps=1e-5)
    return _frame(vertices, eye, x_axis, y_axis, z_axis)


def look(vertices: torch.Tensor, eye, direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
         coordinate: str = 'right') -> torch.Tensor:
    """Camera frame from an explicit viewing direction (reference look.py:3-55)."""
    if vertices.dim() != 3:
        raise ValueError('vertices must have shape [B, N, 3]')
    bs, dev = vertices.shape[0], vertices.device
    direction = device_constant(direction, dev)
    up_v = device_constant(up if up is not None else (0.0, 1.0, 0.0), dev)

    z_axis = normalize(direction, axis=0 if direction.dim() == 1 else -1, eps=1e-5)
    up_v = normalize(up_v, axis=0 if up_v.dim() == 1 else -1, eps=1e-5)

    eye = _as_batched_vec3(eye, bs, dev)
    z_axis = _as_batched_vec3(z_axis, bs, dev)
    up_v = _as_batched_vec3(up_v, bs, dev)

    if coordinate == 'right':
        x_axis = normalize(torch.linalg.cross(up_v, z_axis, dim=-1), eps=1e-5)
        y_axis = normalize(torch.linalg.cross(z_axis, x_axis, dim=-1), eps=1e-5)
    elif coordinate == 'left':
        x_axis = normalize(torch.linalg.cross(z_axis, up_v, dim=-1), eps=1e-5)
        y_axis = normalize(torch.linalg.cross(x_axis, z_axis, dim=-1), eps=1e-5)
    else:
        raise ValueError("coordinate must be 'right' or 'left'")
    return _frame(vertices, eye, x_axis, y_axis, z_axis)


def perspective(vertices: torch.Tensor, angle: float = 30.0) -> torch.Tensor:
    """Perspective divide, field-of-view half-angle in degrees
    (reference perspective.py:4-17)."""
    if vertices.dim() != 3:
        raise ValueError('vertices must have shape [B, N, 3]')
    width = torch.tan(device_constant(angle, vertices.device) / 180.0 * math.pi)
    z = vertices[..., 2]
    x = vertices[..., 0] / z / width
    y = vertices[..., 1] / z / width
    return torch.stack([x, y, z], dim=-1)


def orthogonal(vertices: torch.Tensor, scale) -> torch.Tensor:
    """Orthogonal projection (reference orthogonal.py:3-15)."""
    if vertices.dim() != 3:
        raise ValueError('vertices must have shape [B, N, 3]')
    z = vertices[..., 2]
    x = vertices[..., 0] * scale
    y = vertices[..., 1] * scale
    return torch.stack([x, y, z], dim=-1)


def projection(vertices: torch.Tensor, K, R, t, dist_coeffs=None, orig_size: int = 512,
               eps: float = 1e-9) -> torch.Tensor:
    """Calibrated-camera projection with OpenCV radial/tangential
    distortion (reference projection.py:3-48).

    K: [B,3,3], R: [B,3,3], t: [B,1,3], dist_coeffs: [B,5] (k1,k2,p1,p2,k3).
    Returns [u, v, z] with u, v in [-1, 1].
    """
    dev = vertices.device
    K, R, t = device_constant(K, dev), device_constant(R, dev), device_constant(t, dev)
    if dist_coeffs is None:
        dist_coeffs = torch.zeros((K.shape[0], 5), dtype=torch.float32, device=dev)
    dist_coeffs = device_constant(dist_coeffs, dev)

    # the reference uses R[0]'s transpose for every batch element (:18)
    vertices = torch.matmul(vertices, R.transpose(1, 2)[0]) + t
    x, y, z = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    x_ = x / (z + eps)
    y_ = y / (z + eps)

    k1 = dist_coeffs[:, None, 0]
    k2 = dist_coeffs[:, None, 1]
    p1 = dist_coeffs[:, None, 2]
    p2 = dist_coeffs[:, None, 3]
    k3 = dist_coeffs[:, None, 4]

    x_2, y_2 = x_ * x_, y_ * y_
    r2 = x_2 + y_2
    r4 = r2 * r2
    r6 = r4 * r2
    tmp = k1 * r2 + k2 * r4 + k3 * r6 + 1.0
    x__ = x_ * tmp + 2 * p1 * x_ * y_ + p2 * (r2 + 2 * x_2)
    y__ = y_ * tmp + p1 * (r2 + 2 * y_2) + 2 * p2 * x_ * y_

    pts = torch.stack([x__, y__, torch.ones_like(z)], dim=-1)
    pts = torch.matmul(pts, K.transpose(1, 2)[0])
    u, v = pts[..., 0], pts[..., 1]
    v = orig_size - v
    u = 2 * (u - orig_size / 2.0) / orig_size
    v = 2 * (v - orig_size / 2.0) / orig_size
    return torch.stack([u, v, z], dim=-1)
