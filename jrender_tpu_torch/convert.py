"""Carry a scene and a training state from the JAX package into the port.

A renderer's state is the mesh and the camera.  ``mesh_from_numpy``
builds the port's ``Mesh`` from the public arrays of a JAX ``Mesh``,
taken as numpy (normal maps, TBN frames, texture coordinates and the SSS
flag included); ``scene_from_numpy`` builds the port's ``Scene`` from a
JAX scene's objects and lights, read as numpy arrays and scalars by
``scene_arrays``; ``copy_renderer_state`` copies a JAX ``Renderer``'s
camera eye and light settings onto a port ``Renderer``.  A training
state is demo 2's parameters and the graph data of its losses:
``load_deform_params`` writes a JAX parameter dict (``displace``,
``center``) into a port ``DeformModel``, ``deform_params`` reads them
back as numpy, and ``copy_loss_state`` copies the Laplacian matrix and
the edge lists of the JAX loss objects onto the port's.  A NeRF's state
is its weight tree: ``nerf_params_from_numpy`` builds the port's ``NeRF``
modules from the JAX package's parameter tree taken as numpy, and
``nerf_params_to_numpy`` reads them back.  None of them imports the JAX
package: they read arrays and attributes only.
"""
from __future__ import annotations

import numpy as np
import torch

from .deform import DeformModel
from .loss import FlattenLoss, LaplacianLoss
from .scene import Light, Render, Scene, obj
from .structures import Mesh


def _array(x):
    """A writable numpy copy, or None."""
    return None if x is None else np.array(x)


def mesh_arrays(mesh) -> dict:
    """The public arrays of a JAX ``Mesh`` (or of a port ``Mesh`` on the
    CPU) as writable numpy copies, None where the mesh has none."""
    out = {k: _array(getattr(mesh, k)) for k in (
        'vertices', 'faces', 'textures', 'metallic_textures', 'roughness_textures',
        'normal_textures', 'TBN', 'face_texcoords')}
    out['texture_type'] = mesh.texture_type
    out['dr_type'] = mesh.dr_type
    out['texture_res'] = mesh.texture_res
    out['with_SSS'] = bool(mesh.with_SSS)
    return out


def mesh_from_numpy(arrays: dict, device=None) -> Mesh:
    """Port ``Mesh`` from a dict of numpy arrays: vertices, faces,
    textures, metallic_textures, roughness_textures, normal_textures, TBN,
    face_texcoords, texture_type, dr_type, texture_res and with_SSS
    (``mesh_arrays`` of a JAX mesh)."""
    return Mesh(arrays['vertices'], np.asarray(arrays['faces'], np.int64),
                textures=arrays.get('textures'),
                texture_res=int(arrays.get('texture_res', 1)),
                texture_type=arrays.get('texture_type', 'surface'),
                dr_type=arrays.get('dr_type', 'softras'),
                metallic_textures=arrays.get('metallic_textures'),
                roughness_textures=arrays.get('roughness_textures'),
                normal_textures=arrays.get('normal_textures'),
                TBN=arrays.get('TBN'),
                with_SSS=bool(arrays.get('with_SSS', False)),
                face_texcoords=arrays.get('face_texcoords'),
                device=device)


_OBJ_ARGS = ('Ka', 'Kd', 'Ke', 'Ns', 'Ni')
_OBJ_PATHS = ('map_Kd_path', 'map_normal_path', 'obj_path', 'mtl_path',
              'map_metallic_path', 'map_roughness_path', 'map_albedo_path')
_OBJ_SETTINGS = ('material_name', 'reflection_type', 'kd_res', 'with_specular',
                 'Generate_Normals')
_LIGHT_FIELDS = ('position', 'direction', 'up', 'intensity', 'type', 'area',
                 'viewing_angle', 'viewing_scale', 'near', 'far', 'fillback', 'shadow')


def scene_arrays(scene) -> dict:
    """A JAX ``Scene``'s objects and lights as numpy arrays and scalars:
    {'objects': [dict], 'lights': [dict], 'render_target': [int]}."""
    objects = []
    for o in scene.objects:
        d = {k: getattr(o, '_' + k) for k in _OBJ_ARGS}
        d.update({k: getattr(o, k) for k in _OBJ_PATHS + _OBJ_SETTINGS})
        d['roughness'] = o._roughness
        d['face_vertices'] = _array(o.face_vertices)
        d['face_normals_from_obj'] = _array(o.face_normals_from_obj)
        d['kd_texture_uv'] = _array(o._kd_texture_uv)
        objects.append(d)
    lights = []
    for light in scene.lights:
        d = {k: getattr(light, k) for k in _LIGHT_FIELDS}
        d['color'] = _array(light.color)
        lights.append(d)
    return {'objects': objects, 'lights': lights,
            'render_target': list(scene.render_target)}


def scene_from_numpy(arrays: dict, render: Render | None = None, device=None) -> Scene:
    """Port ``Scene`` from ``scene_arrays`` of a JAX scene, with ``render``
    (default: a ``Render`` on the device)."""
    objects = []
    for d in arrays['objects']:
        o = obj(face_vertices=d['face_vertices'],
                face_normals_from_obj=d['face_normals_from_obj'],
                kd_texture_uv=d['kd_texture_uv'],
                **{k: d[k] for k in _OBJ_ARGS + _OBJ_PATHS},
                material_name=d['material_name'], reflection_type=d['reflection_type'],
                kd_res=d['kd_res'], device=device)
        o._roughness = d['roughness']
        o.with_specular = d['with_specular']
        o.Generate_Normals = d['Generate_Normals']
        objects.append(o)
    lights = []
    for d in arrays['lights']:
        light = Light()
        for k in _LIGHT_FIELDS:
            setattr(light, k, list(d[k]) if isinstance(d[k], (list, tuple)) else d[k])
        light.color = torch.as_tensor(d['color'], dtype=torch.float32)
        lights.append(light)
    scene = Scene(objects, lights, render=render, device=device)
    scene.render_target = list(arrays['render_target'])
    return scene


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


# -- NeRF ---------------------------------------------------------------------

def _nerf_from_tree(tree, device):
    from .nerf.model import NeRF
    pts = tree['pts_linears']
    D = len(pts)
    input_ch, W = np.shape(pts[0]['w'])
    skips = tuple(i for i in range(D - 1) if np.shape(pts[i + 1]['w'])[0] == W + input_ch)
    use_viewdirs = 'feature_linear' in tree
    input_ch_views = np.shape(tree['views_linears'][0]['w'])[0] - W if use_viewdirs else 0
    output_ch = 4 if use_viewdirs else np.shape(tree['output_linear']['w'])[1]
    params = {k: ([{'w': np.asarray(l['w']), 'b': np.asarray(l['b'])} for l in v]
                  if isinstance(v, (list, tuple)) else
                  {'w': np.asarray(v['w']), 'b': np.asarray(v['b'])})
              for k, v in tree.items()}
    return NeRF(D, int(W), int(input_ch), int(input_ch_views), int(output_ch), skips,
                use_viewdirs, params=params, device=device)


def nerf_params_from_numpy(tree, device=None):
    """The port's networks from a JAX NeRF parameter tree taken as numpy:
    ``{'coarse': net, 'fine': net}`` (the trainer's) gives an
    ``nn.ModuleDict`` of ``NeRF``, one net's tree (``{'pts_linears': [{'w',
    'b'}, ...], 'feature_linear', ...}``) a ``NeRF``.  Depth, width, input
    channels, skips and heads are read from the shapes."""
    from torch import nn
    from ._device import resolve_device
    dev = resolve_device(device)
    if 'pts_linears' in tree:
        return _nerf_from_tree(tree, dev)
    return nn.ModuleDict({k: _nerf_from_tree(v, dev) for k, v in tree.items()})


def nerf_params_to_numpy(model):
    """A ``NeRF`` (or an ``nn.ModuleDict`` of them) as the JAX package's
    parameter tree of numpy arrays."""
    from .nerf.model import NeRF

    def one(net):
        t = net.tree()
        return {k: ([{n: a.detach().cpu().numpy().copy() for n, a in l.items()} for l in v]
                    if isinstance(v, list) else
                    {n: a.detach().cpu().numpy().copy() for n, a in v.items()})
                for k, v in t.items()}

    if isinstance(model, NeRF):
        return one(model)
    return {k: one(v) for k, v in model.items()}
