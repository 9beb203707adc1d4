"""Scene graph: object and light container and the deferred rendering entry point.

Counterpart of ``jrender_tpu/scene/scene.py`` (reference
jrender/Scene/scene.py:9-303, with the usemtl-grouped OBJ/MTL loader at
:169-302).  A scene lives on one device, the card unless it is built with
``device='cpu'``; its objects, textures and renderer live there too.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .._device import resolve_device
from .object import obj
from .light import Light
from .render import Render
from .descriptors import (GeometryDescption, MaterialDescption,
                          IlluminationDescption, MultipleRenderTargets)


class Scene:
    def __init__(self, objects=None, lights=None, render=None, device=None):
        self.device = resolve_device(device)
        self.objects: List[obj] = objects if objects is not None else []
        self.lights: List[Light] = lights if lights is not None else []
        self.MRT_update = True
        self._MRT = None
        self.render = render if render is not None else Render(device=self.device)
        self._name_dic = {}
        self.name_dic_update = True
        self.render_target = [i for i in range(len(self.objects))]
        self.print_scene()

    def set_render(self, render):
        self.render = render

    def set_kd_res(self, res):
        for o in self.objects:
            o.kd_res = res
            o.face_kd_update = True
        self.MRT_update = True

    def set_roughness(self, ind, roughness):
        for i in (ind if isinstance(ind, list) else [ind]):
            self.objects[i]._roughness = roughness
        self.MRT_update = True

    def set_render_target(self, index):
        self.render_target = index if isinstance(index, list) else [index]
        self.MRT_update = True

    def set_reflection(self, ind, type):
        self.objects[ind].reflection_type = type

    def set_specular(self, ind, with_specular):
        for i in (ind if isinstance(ind, list) else [ind]):
            self.objects[i].with_specular = with_specular
        self.MRT_update = True

    def set_GenerateNormal(self, ind, mode):
        for i in (ind if isinstance(ind, list) else [ind]):
            self.objects[i].Generate_Normals = mode
            self.objects[i].face_normals_update = True
        self.MRT_update = True

    def set_rescaling(self, ind, scale):
        for i in (ind if isinstance(ind, list) else [ind]):
            self.objects[i].rescaling(scale)
        self.MRT_update = True

    def print_scene(self):
        print('Scene:')
        for name in self.name_dic.keys():
            print(f'name:{name} ind:{self.name_dic[name]}')

    @property
    def name_dic(self):
        if self.name_dic_update:
            self._name_dic = {o.material_name: i for i, o in enumerate(self.objects)}
            self.name_dic_update = False
        return self._name_dic

    @property
    def MRT(self):
        if self.MRT_update:
            parts = {k: [] for k in ('w', 'n', 'kd', 'al', 'me', 'ro', 'sp')}
            for i in self.render_target:
                o = self.objects[i]
                parts['w'].append(o.face_vertices)
                parts['n'].append(o.face_normals)
                parts['al'].append(o.face_albedo)
                parts['me'].append(o.face_metallic)
                parts['ro'].append(o.face_roughness)
                parts['sp'].append(o.specular)
                parts['kd'].append(o.face_kd)
            cat = {k: torch.cat(v, 0) for k, v in parts.items()}
            metallic_roughness = torch.cat([cat['me'], cat['ro'], cat['sp']], 2)
            self._MRT = MultipleRenderTargets(
                worldcoords=cat['w'], normals=cat['n'], KD=cat['kd'],
                albedo=cat['al'], metallic_roughness=metallic_roughness)
            self.MRT_update = False
        return self._MRT

    def GeometryDesc(self):
        obj_faces = {}
        nf = 0
        for i in self.render_target:
            fv = self.objects[i].face_vertices
            obj_faces[f'{i}'] = [nf, nf + fv.shape[0]]
            nf += fv.shape[0]
        return GeometryDescption(obj_faces, self.name_dic)

    def MaterialDesc(self, PBR):
        return MaterialDescption([self.objects[i] for i in self.render_target],
                                 PBR=PBR)

    def IlluminationDesc(self, shading):
        return IlluminationDescption(self.lights, shading=shading)

    def append_light(self, lights):
        for light in (lights if isinstance(lights, list) else [lights]):
            self.lights.append(light)

    def deferred_render(self, shading='Cook_Torrance'):
        self.render.MRT = self.MRT
        self.render.GeometryDesc = self.GeometryDesc()
        self.render.IlluminationDesc = self.IlluminationDesc(shading)
        self.render.MaterialDesc = self.MaterialDesc(PBR=(shading == 'Cook_Torrance'))
        return self.render.fragment_shader()

    @classmethod
    def load_scene_from_obj(cls, filenames, device=None):
        dev = resolve_device(device)
        objects = []
        for filename in (filenames if isinstance(filenames, list) else [filenames]):
            if filename.split('.')[-1] == 'obj':
                objects += load_obj(filename, device=dev)
        return cls(objects, device=dev)


def load_obj(filename, device=None):
    """usemtl-grouped OBJ/MTL loader (scene.py:169-302): one ``obj`` per
    material, on ``device``."""
    dev = resolve_device(device)
    objects = []
    obj_group = {}
    vertices = []
    texcoords = []
    normals = []
    world_ind = []
    tex_ind = []
    normal_ind = []
    filename_mtl = None
    with open(filename) as f:
        lines = f.readlines()

    for line in lines:
        if line.startswith('mtllib'):
            filename_mtl = os.path.join(os.path.dirname(filename), line.split()[1])

    material_name = ''
    length = len(lines)
    for i, line in enumerate(lines):
        parts = line.split()
        if not parts:
            if i == length - 1:
                parts = ['usemtl', 'end']
            else:
                continue
        tok = parts[0]
        if tok == 'v':
            vertices.append([float(v) for v in parts[1:4]])
        elif tok == 'vn':
            normals.append([float(vn) for vn in parts[1:4]])
        elif tok == 'vt':
            texcoords.append([float(vt) for vt in parts[1:3]])
        elif tok == 'f':
            index = parts[1:]
            if len(index) == 4:
                index = index[:3] + index[2:] + [index[0]]
            for ind in index:
                v = ind.split('/')
                world_ind.append(int(v[0]))
                if len(v) >= 2 and v[1] != '':
                    tex_ind.append(int(v[1]))
                if len(v) == 3 and v[2] != '':
                    normal_ind.append(int(v[2]))
        if tok == 'usemtl' or i == length - 1:
            next_name = parts[1] if tok == 'usemtl' else 'end'
            if material_name == '':
                material_name = next_name
                continue
            if world_ind:
                fw = np.reshape(world_ind, (-1, 3)) - 1
                face_vertices = np.asarray(vertices, np.float32)[fw]
                face_texcoords = (np.asarray(texcoords, np.float32)[
                    np.reshape(tex_ind, (-1, 3)) - 1] if tex_ind else None)
                face_normals = (np.asarray(normals, np.float32)[
                    np.reshape(normal_ind, (-1, 3)) - 1] if normal_ind else None)
                if material_name in obj_group:
                    prev = obj_group[material_name]
                    face_vertices = np.concatenate([face_vertices, prev['face_vertices']], 0)
                    if face_texcoords is not None and prev['face_texcoords'] is not None:
                        face_texcoords = np.concatenate([face_texcoords, prev['face_texcoords']], 0)
                    if face_normals is not None and prev['face_normals'] is not None:
                        face_normals = np.concatenate([face_normals, prev['face_normals']], 0)
                obj_group[material_name] = {'face_vertices': face_vertices,
                                            'face_texcoords': face_texcoords,
                                            'face_normals': face_normals}
            material_name = next_name
            world_ind = []
            tex_ind = []
            normal_ind = []

    if filename_mtl is not None and os.path.exists(filename_mtl):
        nxt = 0
        material_name = ''
        with open(filename_mtl) as f:
            for line in f.readlines():
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == 'newmtl':
                    material_name = parts[1]
                    nxt = 0 if material_name in obj_group else 1
                    continue
                if nxt:
                    continue
                if parts[0] == 'map_Kd':
                    obj_group[material_name]['map_Kd'] = parts[1]
                elif parts[0] == 'map_normal':
                    obj_group[material_name]['map_normal'] = parts[2]
                elif parts[0] == 'Kd':
                    obj_group[material_name]['Kd'] = list(map(float, parts[1:4]))
                elif parts[0] == 'Ka':
                    obj_group[material_name]['Ka'] = list(map(float, parts[1:4]))
                elif parts[0] == 'Ke':
                    obj_group[material_name]['Ke'] = list(map(float, parts[1:4]))
                elif parts[0] == 'Ns':
                    obj_group[material_name]['Ns'] = parts[1]
                elif parts[0] == 'Ni':
                    obj_group[material_name]['Ni'] = parts[1]

    for name, g in obj_group.items():
        map_Kd = g.get('map_Kd')
        if map_Kd is not None:
            map_Kd = os.path.join(os.path.dirname(filename), map_Kd)
        map_normal = g.get('map_normal')
        if map_normal is not None:
            map_normal = os.path.join(os.path.dirname(filename), map_normal)
        objects.append(obj(Ka=g.get('Ka'), Kd=g.get('Kd'), Ke=g.get('Ke'),
                           Ns=g.get('Ns'), Ni=g.get('Ni'),
                           face_vertices=g['face_vertices'],
                           material_name=name,
                           kd_texture_uv=g['face_texcoords'],
                           face_normals_from_obj=g['face_normals'],
                           map_Kd_path=map_Kd, map_normal_path=map_normal,
                           obj_path=filename, mtl_path=filename_mtl, device=dev))
    return objects
