"""Texture with a UV query cache, mipmaps and summed-area tables.

Counterpart of ``jrender_tpu/scene/texture.py`` (reference
jrender/Scene/textures/texture.py: sample2D sampler :33, mipmap :82-102,
SAT :115-139).  A texture holds its image on one device, the card unless
it is built with ``device='cpu'``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as Fn

from .._device import resolve_device
from ..io.image import read_raw
from ..ops.image import generate_SAT, sample2D


class Texture:
    def __init__(self, image=None, uv=None, sampler=sample2D, device=None):
        self.device = resolve_device(device)
        self._image = None
        self.height = None
        self.width = None
        self._channel = None
        if image is not None:
            self.image = image
        self._uv = uv
        self._query_uv = None
        self.query_uv_update = True
        self.sampler = sampler
        self._mipmap = None
        self.mipmap_update = True

    @property
    def query_uv(self):
        if self._uv is None:
            raise ValueError('The texture has not been attached to uvs')
        if self.query_uv_update:
            self._query_uv = self.sampler(self.image, self._uv, default=99999)
            self.query_uv_update = False
        return self._query_uv

    @property
    def uv(self):
        return self._uv

    @uv.setter
    def uv(self, _uv):
        self._uv = _uv
        self.update()

    @property
    def image(self):
        return self._image

    @image.setter
    def image(self, image):
        self._image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        self._channel = 1 if self._image.dim() == 2 else self._image.shape[2]
        self.height = self._image.shape[0]
        self.width = self._image.shape[1]
        self.update()

    @property
    def channel(self):
        return self._channel

    def update(self):
        self.query_uv_update = True
        self.mipmap_update = True

    @classmethod
    def generate_mipmap(cls, image):
        """Flat mipmap pyramid [1, N] and its level offsets (texture.py:82-102).

        The JAX package resizes each level with PIL's ``BILINEAR`` filter on
        a float image; this one with ``interpolate(mode='bilinear',
        antialias=True)``, the same triangle filter widened by the scale,
        on the image's device.  The two differ by rounding (the test states
        the tolerance it reads).  Level sizes halve with Python's rounding,
        as in the JAX package; each level is resized from the one before."""
        image = torch.as_tensor(image, dtype=torch.float32)
        height, width = image.shape[0], image.shape[1]
        max_level = math.floor(math.log2(min(height, width)))
        levels = [image.reshape(1, width * height)]
        index = [0, width * height]
        cur = image
        for level in range(max_level):
            width = int(round(width / 2))
            height = int(round(height / 2))
            cur = Fn.interpolate(cur[None, None], size=(height, width), mode='bilinear',
                                 align_corners=False, antialias=True)[0, 0]
            levels.append(cur.reshape(1, width * height))
            index.append(index[level + 1] + width * height)
        return torch.cat(levels, 1), torch.as_tensor(index, dtype=torch.int32,
                                                      device=image.device)

    @classmethod
    def from_path(cls, path, device=None):
        """The image at ``path`` in [0,1], alpha dropped and gray kept [H,W]
        (JAX texture.py:91-99), or None."""
        if path is None:
            return None
        image = torch.from_numpy(np.array(read_raw(path))).float() / 255.0
        if image.dim() == 3 and image.shape[2] == 4:
            image = image[..., :3]
        return cls(image, device=device)

    @classmethod
    def generate_SAT(cls, image):
        """SAT[y, x] = sum of image[:y+1, :x+1] (texture.py:128-139)."""
        return generate_SAT(image)
