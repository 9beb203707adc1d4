"""What the mesh kinds (``kinds/fit.py``, ``kinds/frames.py``) share: the
configuration's textured sphere and an eye table made from the seed, and
the layer context their per-layer readers read.

The seed fixes the textures, the offsets' parameter, a phase added to every
azimuth and whatever the kind draws after them (a fit's turn per step and
targets); every seed gets the same sizes.  Everything is made on the card
in a few calls of a ``torch.Generator`` there; the eyes of each step or
request come from a table made at set-up, so a call reads nothing from the
host.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import peaks
from benchmark.reference import scene

TABLE = 16384            # steps or requests whose eyes the table holds


@dataclasses.dataclass
class Inputs:
    template: torch.Tensor       # [1,V,3]
    faces: torch.Tensor          # [1,F,3] int64
    textures: torch.Tensor       # [1,F,...] the textures at the start
    raw: torch.Tensor            # [1,V,3] the offsets' parameter at the start (fit)
    offset_scale: float          # offsets = offset_scale * tanh(raw)
    targets: dict                # name -> [N,...] (fit)
    eyes: torch.Tensor           # [TABLE, N, 3]
    views: int

    def batch(self, x):
        return x.expand(self.views, *([-1] * (x.dim() - 1)))

    def vertices(self, raw):
        """The mesh's vertices [1,V,3] at the offsets' parameter ``raw``."""
        return self.template + self.offset_scale * torch.tanh(raw)


def make_inputs(cfg: dict, mix: dict, seed: int, device, azimuths, targets=None) -> Inputs:
    """The sphere, its textures, the offsets' parameter and the eye table.
    ``azimuths(phase, k, j, g)`` gives the azimuth of view ``j`` of step or
    request ``k`` (float64, [TABLE, N]), drawing from ``g`` what it needs;
    ``targets(cfg, N, g, device)``, where given, the targets, drawn last."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sph = cfg['mesh']['uv_sphere']
    v, f = scene.uv_sphere(sph['rings'], sph['segs'], sph['radius'], device=device)
    F, N = f.shape[0], mix['views']
    textures = torch.rand((1, F, *cfg['textures']), generator=g, device=device)
    raw = torch.rand((1, v.shape[0], 3), generator=g, device=device) - 0.5
    phase = torch.rand((), generator=g, device=device, dtype=torch.float64) * 360
    k = torch.arange(TABLE, device=device, dtype=torch.float64)[:, None]
    j = torch.arange(N, device=device, dtype=torch.float64)[None, :]
    az = azimuths(phase, k, j, g)
    cam = cfg['camera']
    eyes = scene.eyes_from_angles(cam['distance'], cam['elevation'],
                                  torch.remainder(az, 360.0)).to(torch.float32)
    return Inputs(template=v[None], faces=f[None], textures=textures, raw=raw,
                  offset_scale=mix.get('offset_scale', 0.0),
                  targets={} if targets is None else targets(cfg, N, g, device),
                  eyes=eyes.contiguous(), views=N)


def layer_context(cell, prog, ref, inp: Inputs, geometry, tr, host: list, n: int, first: int,
                  fit: bool) -> dict:
    """What the per-layer readers read: the trace's spans and activity, the
    host times, and the least time of the rasterizer and of the step on the
    traced window's inputs (counted by the reference from ``geometry``, the
    vertices and textures as the window starts)."""
    cfg = cell.config
    vertices, textures = geometry
    eyes = inp.eyes[first % TABLE]
    counts = ref.census(cfg, inp.batch(vertices), inp.batch(inp.faces), inp.batch(textures), eyes)
    ops, nbytes = ref.least_work(cfg, counts, inp.views, fit)
    kind_name = torch.cuda.get_device_name(0)
    N, V, HW = inp.views, vertices.shape[1], cfg['image_size'] ** 2
    tex = textures[0].numel()
    other = 4 * ((N + 1) * tex + (N + 1) * V * 3)           # lighting, transform
    if fit:
        other += 4 * (3 * N * 4 * HW + 7 * (V * 3 + tex))   # loss, Adam
    lighting, _ = tr.span_device_s('renderer\\.lighting')
    transform, _ = tr.span_device_s('renderer\\.transform')
    raster, _ = tr.span_device_s('raster\\.forward')
    if fit and prog.backward_op:
        raster += tr.span_device_s(prog.backward_op)[0]
    return {
        'steps': n, 'host_s': host, 'window_s': tr.window_s,
        'busy_s': tr.busy_s, 'activities': tr.activities,
        'lighting_s': lighting, 'transform_s': transform, 'raster_s': raster,
        'least_raster_s': peaks.least_seconds(ops, nbytes, kind_name),
        'least_step_s': peaks.least_seconds(ops, nbytes + other, kind_name),
        'counts': counts, 'trace': tr,
    }
