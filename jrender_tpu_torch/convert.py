"""Carry a scene and a training state from the JAX package into the port.

A renderer's state is the mesh and the camera.  ``mesh_from_numpy``
builds the port's ``Mesh`` from the public arrays of a JAX ``Mesh``,
taken as numpy; ``copy_renderer_state`` copies a JAX ``Renderer``'s
camera eye and light settings onto a port ``Renderer``.  A training
state is demo 2's parameters and the graph data of its losses:
``load_deform_params`` writes a JAX parameter dict (``displace``,
``center``) into a port ``DeformModel``, ``deform_params`` reads them
back as numpy, and ``copy_loss_state`` copies the Laplacian matrix and
the edge lists of the JAX loss objects onto the port's.  None of them
imports the JAX package: they read arrays and attributes only.
"""
from __future__ import annotations

import numpy as np
import torch

from .deform import DeformModel
from .loss import FlattenLoss, LaplacianLoss
from .structures import Mesh


def mesh_arrays(mesh) -> dict:
    """The public arrays of a JAX ``Mesh`` (or of a port ``Mesh`` on the
    CPU) as writable numpy copies."""
    out = {k: np.array(getattr(mesh, k)) for k in (
        'vertices', 'faces', 'textures', 'metallic_textures', 'roughness_textures')}
    out['texture_type'] = mesh.texture_type
    out['dr_type'] = mesh.dr_type
    out['texture_res'] = mesh.texture_res
    return out


def mesh_from_numpy(arrays: dict, device=None) -> Mesh:
    """Port ``Mesh`` from a dict of numpy arrays: vertices, faces,
    textures, metallic_textures, roughness_textures, texture_type,
    dr_type and texture_res (``mesh_arrays`` of a JAX mesh)."""
    return Mesh(arrays['vertices'], np.asarray(arrays['faces'], np.int64),
                textures=arrays.get('textures'),
                texture_res=int(arrays.get('texture_res', 1)),
                texture_type=arrays.get('texture_type', 'surface'),
                dr_type=arrays.get('dr_type', 'softras'),
                metallic_textures=arrays.get('metallic_textures'),
                roughness_textures=arrays.get('roughness_textures'),
                device=device)


def _plain(x):
    """A camera or light value as plain Python numbers or a tensor."""
    if isinstance(x, (int, float)):
        return x
    if isinstance(x, (tuple, list)) and all(isinstance(v, (int, float)) for v in x):
        return type(x)(x)
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def copy_renderer_state(src, dst) -> None:
    """Copy the camera eye and the light settings of renderer ``src``
    (a JAX ``Renderer``) onto ``dst`` (a port ``Renderer``)."""
    dst.transform.transformer._eye = _plain(src.transform.transformer._eye)
    amb_s, amb_d = src.lighting.ambient, dst.lighting.ambient
    amb_d.light_intensity = amb_s.light_intensity
    amb_d.light_color = _plain(amb_s.light_color)
    for ds, dd in zip(src.lighting.directionals, dst.lighting.directionals):
        dd.light_intensity = ds.light_intensity
        dd.light_color = _plain(ds.light_color)
        dd.light_direction = _plain(ds.light_direction)


def load_deform_params(model: DeformModel, params: dict) -> None:
    """Write demo 2's parameters (a dict of arrays ``displace`` [1,V,3] and
    ``center`` [1,1,3], as the JAX demo keeps them) into ``model``."""
    with torch.no_grad():
        for name in ('displace', 'center'):
            dst = getattr(model, name)
            dst.copy_(torch.as_tensor(np.asarray(params[name]), dtype=dst.dtype)
                      .reshape(dst.shape))


def deform_params(model: DeformModel) -> dict:
    """Demo 2's parameters of ``model`` as numpy arrays."""
    return {name: getattr(model, name).detach().cpu().numpy().copy()
            for name in ('displace', 'center')}


def copy_loss_state(src, dst) -> None:
    """Copy the graph data of a JAX ``LaplacianLoss`` or ``FlattenLoss``
    ``src`` onto the port's loss ``dst`` of the same kind, so that both
    packages regularise over the same matrix or edge list."""
    if isinstance(dst, LaplacianLoss):
        names = ('laplacian',)
    elif isinstance(dst, FlattenLoss):
        names = ('v0s', 'v1s', 'v2s', 'v3s')
    else:
        raise TypeError(f'copy_loss_state takes a LaplacianLoss or a FlattenLoss, '
                        f'got {type(dst).__name__}')
    for name in names:
        old = getattr(dst, name)
        new = torch.as_tensor(np.asarray(getattr(src, name)), device=old.device).to(old.dtype)
        setattr(dst, name, new)
    dst.average = src.average
