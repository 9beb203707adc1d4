"""Save meshes to .obj, with an .mtl and a texture atlas PNG.

Counterpart of ``jrender_tpu/io/save_obj.py`` (``save_obj`` :14,
``save_voxel`` :66; reference jrender/io/save_obj.py:31-96): the text is
line for line the JAX package's for the same arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.texture import create_texture_image
from .image import imwrite


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_obj(filename, vertices, faces, textures=None, texture_res=16,
             texture_type='surface'):
    assert texture_type in ('surface', 'vertex')
    vertices = _numpy(vertices)
    faces = _numpy(faces)

    filename_mtl = filename[:-4] + '.mtl'
    vertices_textures = None
    if textures is not None and texture_type == 'surface':
        assert texture_res >= 2
        texture_image, vertices_textures = create_texture_image(textures, texture_res)
        imwrite(filename[:-4] + '.png',
                (np.clip(texture_image, 0, 1) * 255).astype('uint8'))

    with open(filename, 'w') as f:
        f.write('# %s\n#\n\n' % os.path.basename(filename))
        if textures is not None:
            f.write('mtllib %s\n\n' % os.path.basename(filename_mtl))

        if textures is not None and texture_type == 'vertex':
            for vertex, color in zip(vertices, _numpy(textures)):
                f.write('v %.8f %.8f %.8f %.8f %.8f %.8f\n' % (
                    vertex[0], vertex[1], vertex[2], color[0], color[1], color[2]))
            f.write('\n')
        else:
            for vertex in vertices:
                f.write('v %.8f %.8f %.8f\n' % (vertex[0], vertex[1], vertex[2]))
            f.write('\n')

        if textures is not None and texture_type == 'surface':
            for vertex in vertices_textures.reshape(-1, 2):
                f.write('vt %.8f %.8f\n' % (vertex[0], vertex[1]))
            f.write('\n')
            f.write('usemtl %s\n' % 'material_1')
            for i, face in enumerate(faces):
                f.write('f %d/%d %d/%d %d/%d\n' % (
                    face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2, face[2] + 1, 3 * i + 3))
            f.write('\n')
        else:
            for face in faces:
                f.write('f %d %d %d\n' % (face[0] + 1, face[1] + 1, face[2] + 1))

    if textures is not None and texture_type == 'surface':
        with open(filename_mtl, 'w') as f:
            f.write('newmtl material_1\n')
            f.write('map_Kd %s\n' % os.path.basename(filename[:-4] + '.png'))


def save_voxel(filename, voxel):
    voxel = _numpy(voxel)
    coords = np.argwhere(voxel == 1).astype(np.float32)
    coords /= np.asarray(voxel.shape, np.float32)[None, :]
    return save_obj(filename, coords, np.zeros((0, 3), np.int32))
