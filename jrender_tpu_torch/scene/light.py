"""Light source description (counterpart of ``jrender_tpu/scene/light.py``;
reference jrender/Scene/objects/light.py:6-21).

A light holds plain values: positions and directions as lists, its colour
as a float32 tensor on the CPU, which the renderer moves to its device.
"""
from __future__ import annotations

import torch

from ..utils.math import normalize


class Light:
    def __init__(self, position=(0, 0, 0), direction=(0, 0, 1), color=(1, 1, 1),
                 up=(0, 1, 0), intensity=0.5, area=0, type='directional',
                 shadow=True, view_angle=45, viewing_scale=0.9):
        self.position = list(position)
        self.direction = list(direction)
        self.up = list(up)
        self.color = normalize(torch.as_tensor(color, dtype=torch.float32), axis=0)
        self.intensity = intensity
        self.type = type
        self.area = area
        self.viewing_angle = view_angle
        self.viewing_scale = viewing_scale
        self.near = 0.1
        self.far = 100
        self.fillback = False
        self.shadow = shadow
        self.DepthMap = None
