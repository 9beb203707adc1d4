#!/usr/bin/env python3
"""The px_f backward on the card, stage by stage: the counterpart of
``tools/profile_bwd.py`` (T3), which times the JAX package's px_f backward
kernel (``_make_bwd_kernel_pf``, its pallas_call at :147) and the stages
around it on the TPU.

    python3 tools/profile_torch_bwd.py [--reps N]

T3's two spheres (``uv_sphere(13, 12)``, 288 faces, and ``uv_sphere(130,
153)``, 39,474 faces) at 1024 px, T = 25 surface texels, eye [0, 0,
-2.732], angle 30, sigma 1e-5, gamma 1e-4, top-K gradient with K = 16, on
the px_f route (``route.with_layout('px_f')``).  The port's stages are not
the TPU's: its prep comes before the forward and is kept for the backward,
and K6 reads the forward's maps directly (no px build).  Each stage is
timed alone, and the whole ``soft_rasterize`` step besides:

  prep       ``pxf_impl.prep_pxf(..., for_grad=True)`` (binning, rows, items)
  fwd_thr    K5 with the threshold (``pxf_impl.launch_pxf_fwd``)
  k6         K6 alone (``tiled.bwd_args`` + ``cuda_impl._run``)
  face_sum   the segment sum of K6's rows (``tiled.face_sum``)
  backward   ``pxf_impl.backward`` (K6 and the face sum through the wrappers)
  step       ``soft_rasterize`` forward and backward

For each: its device time per call (``device_total``: every kernel, copy
and fill, from traces that agree on a whole number of kernels a call, at
least the wrappers' count; ``device_ms`` for K6's own kernel), its host
time by CUDA events, its launches by the wrappers' counters and by
torch.profiler.  Then the
step's work items and its host synchronisations (one step under
``torch.cuda.set_sync_debug_mode('warn')``, its warnings counted).  The
stage functions (``case``, ``prep``, ``k6_rows``, ``backward_by_stages``,
``step``) also run on the CPU, on the plain versions.  Prints a JSON line
per sphere beside the card's name and power limit.  Imports neither JAX
nor ``bench.py``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from jrender_tpu_torch.ops import segment_sum  # noqa: E402
from jrender_tpu_torch.ops.softras import (cuda_impl, make_params, pxf_impl, route,  # noqa: E402
                                           soft_rasterize, tiled)
from jrender_tpu_torch.structures import face_vertices  # noqa: E402
from jrender_tpu_torch.transform import look_at, perspective  # noqa: E402
from jrender_tpu_torch.utils.primitives import uv_sphere  # noqa: E402

IMAGE_SIZE = 1024
SPHERES = {'small': (13, 12), 'large': (130, 153)}
T = 25
SEED = 0       # the textures' and the incoming gradient's generator
K6_KERNELS = {'k6': ('softras_tile_bwd_kernel',)}


def params(image_size: int = IMAGE_SIZE):
    """T3's settings."""
    return make_params(image_size=image_size, sigma_val=1e-5, gamma_val=1e-4,
                       texture_type='surface', grad_mode='topk',
                       max_faces_per_pixel_for_grad=16)


def case(rings: int, segs: int, image_size: int = IMAGE_SIZE, device='cuda'):
    """(face_vertices [1, F, 9], textures [1, F, 25, 3], params, grad_images
    [1, 4, is, is]) of T3's sphere (``bench.py``'s, as
    ``utils.primitives.uv_sphere`` makes it), the textures and the incoming
    gradient from a numpy generator seeded ``SEED``."""
    v, f = uv_sphere(rings, segs)
    vt = perspective(look_at(torch.tensor(v, device=device)[None], (0.0, 0.0, -2.732)),
                     angle=30)
    fv = face_vertices(vt, torch.tensor(f, dtype=torch.int64, device=device)[None])
    fv = fv.reshape(1, -1, 9).contiguous()
    rng = np.random.RandomState(SEED)
    tex = torch.tensor(rng.uniform(size=(1, fv.shape[1], T, 3)).astype(np.float32),
                       device=device)
    g = torch.tensor(rng.standard_normal((1, 4, image_size, image_size)).astype(np.float32),
                     device=device)
    return fv, tex, params(image_size), g


def prep(fv, tex, p):
    """The px_f table with each face's entries (the backward's)."""
    return pxf_impl.prep_pxf(fv, tex, p, for_grad=True)


def forward(pin, p):
    """K5 with the threshold: (images, aggrs, counts, thr)."""
    return pxf_impl.forward(pin, p, True)


def k6_rows(pin, images, aggrs, thr, grad, p):
    """K6's entry rows [E, GC]: on the card its kernel alone (its arguments
    by ``tiled.bwd_args``, launched by ``cuda_impl._run``, no wrapper
    count); on the CPU its plain version."""
    if pin.rows.device.type == 'cpu':
        return tiled.bwd_rows_plain(pin, images, aggrs, thr, grad, p)
    args, grows = tiled.bwd_args(pin, images, aggrs, thr, grad.contiguous(), p)
    if args.W:
        fn = cuda_impl._entry('softras_pxf_bwd', 'softras_pxf_bwd', tiled._TileBwdArgs)
        cuda_impl._run(fn, 'softras_pxf_bwd', args, pin.rows.device)
    return grows


def backward_by_stages(pin, images, aggrs, thr, grad, p):
    """(grad_face_vertices, grad_textures): K6's rows, then the face sum."""
    return tiled.face_sum(pin, k6_rows(pin, images, aggrs, thr, grad, p), p)


def step(fv, tex, p, grad):
    """One ``soft_rasterize`` forward and backward on the px_f route with
    incoming gradient ``grad``: (images, grad_face_vertices, grad_textures)."""
    fv_l = fv.detach().clone().requires_grad_(True)
    tex_l = tex.detach().clone().requires_grad_(True)
    with route.with_layout('px_f'):
        images = soft_rasterize(fv_l, tex_l, image_size=p.image_size, sigma_val=p.sigma_val,
                                gamma_val=p.gamma_val, texture_type=p.texture_type,
                                max_faces_per_pixel_for_grad=p.max_faces_id,
                                grad_mode=p.grad_mode, device=fv.device)
        images.backward(grad)
    return images, fv_l.grad, tex_l.grad


def step_rows(fv, tex, p, grad):
    """The step's own K6 launch: (its table, its rows), captured around
    ``tiled.launch_bwd``, which ``pxf_impl.launch_pxf_bwd`` calls (and
    still counts)."""
    seen = {}
    launch = tiled.launch_bwd

    def spy(source, pin, *a):
        rows = launch(source, pin, *a)
        if source == 'softras_pxf_bwd':
            seen['pin'], seen['rows'] = pin, rows
        return rows

    tiled.launch_bwd = spy
    try:
        step(fv, tex, p, grad)
    finally:
        tiled.launch_bwd = launch
    return seen['pin'], seen['rows']


_WRAPPERS = {'softras_pxf_fwd': pxf_impl.launch_pxf_fwd,
             'softras_pxf_bwd': pxf_impl.launch_pxf_bwd,
             'segment_sum': segment_sum.launch_segment_sum}


def _counted(fn):
    """The wrappers' launches during one call of fn."""
    for w in _WRAPPERS.values():
        w.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k: w.launches for k, w in _WRAPPERS.items() if w.launches}


def sync_count(fn) -> int:
    """Host synchronisations of one call of fn: the warnings of
    ``torch.cuda.set_sync_debug_mode('warn')``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            n = sum('synchroniz' in str(w.message) for w in caught)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return n


def profile(name: str, reps: int = 10) -> dict:
    """Every stage of T3's sphere ``name`` on the card, with K6's rows held
    bit for bit to the step's own K6 launch and the stages' backward to
    ``pxf_impl.backward``'s.  Raises on a difference."""
    from jrender_tpu_torch.utils.device_time import device_ms, device_total, events_ms
    dev = torch.device('cuda')
    fv, tex, p, g = case(*SPHERES[name], device=dev)
    pin = prep(fv, tex, p)
    images, aggrs, _, thr = forward(pin, p)
    rows = k6_rows(pin, images, aggrs, thr, g, p)
    gf, gt = backward_by_stages(pin, images, aggrs, thr, g, p)
    wf, wt = pxf_impl.backward(pin, images, aggrs, thr, g, p)
    _, step_r = step_rows(fv, tex, p, g)
    torch.cuda.synchronize()
    if not torch.equal(rows, step_r):
        raise AssertionError(f'{name}: the tool\'s K6 rows differ from the step\'s own K6 launch')
    if not (torch.equal(gf, wf) and torch.equal(gt, wt)):
        raise AssertionError(f'{name}: the stages\' backward differs from pxf_impl.backward\'s')
    stages = {
        'prep': lambda: prep(fv, tex, p),
        'fwd_thr': lambda: pxf_impl.launch_pxf_fwd(pin, p, True),
        'k6': lambda: k6_rows(pin, images, aggrs, thr, g, p),
        'face_sum': lambda: tiled.face_sum(pin, rows, p),
        'backward': lambda: pxf_impl.backward(pin, images, aggrs, thr, g, p),
        'step': lambda: step(fv, tex, p, g),
    }
    out = {'F': fv.shape[1], 'items': pin.items.shape[0], 'entries': pin.entries.numel()}
    for k, fn in stages.items():
        counted = _counted(fn)
        # K6 alone launches its kernel past the wrappers' counters
        tot = device_total(fn, reps, least=sum(counted.values()) + (k == 'k6'))
        out[k] = {'device_ms': tot['device_ms'], 'host_ms': events_ms(fn, reps),
                  'wrapper_launches': counted, 'kernels': tot['kernels'],
                  'copies': tot['copies']}
        if k == 'step':   # its eight largest kernels, by names cut before their arguments
            short = {}
            for name, ms in tot['by_kernel'].items():
                key = name.split('(')[0][:80]
                short[key] = short.get(key, 0.0) + ms
            out[k]['by_kernel'] = dict(sorted(short.items(), key=lambda kv: -kv[1])[:8])
    out['k6']['kernel_device_ms'] = device_ms(stages['k6'], K6_KERNELS, reps=reps)['k6']
    out['step']['syncs'] = sync_count(stages['step'])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_torch_bwd: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    from jrender_tpu_torch import _build
    _build.build(['softras_fwd', 'softras_pxf_fwd', 'softras_pxf_bwd', 'segment_sum'])
    print(f'build: {time.time() - t0:.1f} s', flush=True)
    for name in SPHERES:
        r = profile(name, args.reps)
        print(name, json.dumps({**r, 'card': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
