#!/usr/bin/env python3
"""Time the port's sums per vertex and per face, and the steps that run
them, on one CUDA card.

    python3 tools/time_fixed_order_sums.py [--repo PATH] [--tag NAME]

Imports ``jrender_tpu_torch`` from PATH (default: the checkout that holds
this script), so that one call can time two trees of the port in turns,
for example a tree whose sums use ``index_add_`` against one whose sums
use the fixed-order segment sum (``ops/segment_sum.py``).  On the
39,474-face ``uv_sphere(130, 153)`` at 1024 px, demo 1's camera, it
prints one JSON line with the card's name and power limit and, in ms
(CUDA events; the median of 5 rounds of 10 calls after a warm-up):

  * ``depth_gradient_ms``: N3MR's depth gradient alone
    (``ops.n3mr.torch_impl.backward_depth``) on the frame's maps;
  * ``rasterize_step_ms``: ``rasterize(...).sum().backward()`` with 2x2x2
    texels per face, what bench.py's n3mr_row times (rgb only: it runs no
    depth gradient);
  * ``rgbad_step_ms``: ``rasterize_rgbad`` with rgb, alpha and depth in the
    loss, whose backward runs the depth gradient;
  * ``vertex_normals_ms``: ``structures.vertex_normals_fn`` forward and
    backward on the sphere's vertices.

Seeded; needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--repo', default=str(REPO), help='tree to import jrender_tpu_torch from')
    ap.add_argument('--tag', default='', help='a label printed with the numbers')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_fixed_order_sums: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import jrender_tpu_torch
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, rasterize, rasterize_rgbad
    from jrender_tpu_torch.ops.n3mr import torch_impl as nplain
    from jrender_tpu_torch.structures import face_vertices, vertex_normals_fn
    from jrender_tpu_torch.transform import look_at, perspective
    from jrender_tpu_torch.utils.primitives import uv_sphere

    dev = torch.device('cuda')
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, reps=10, rounds=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(rounds):
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / reps)
        return float(np.median(times))

    v, f = uv_sphere(130, 153)
    vt = perspective(look_at(torch.tensor(v, device=dev)[None], (0.0, 0.0, -2.732)), angle=30)
    face = face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    tex = torch.rand((1, face.shape[1], 2, 2, 2, 3), generator=gen, device=dev)
    _, fi, wt, dp, finv, zc, _ = ncuda.forward_maps(face, None, 1024, 0.1, 100.0, 1e-3)
    g_depth = torch.randn(dp.shape, generator=gen, device=dev)
    face_leaf = face.reshape(1, -1, 3, 3).clone().requires_grad_(True)
    tex_leaf = tex.clone().requires_grad_(True)

    def raster_step():
        face_leaf.grad = tex_leaf.grad = None
        rasterize(face_leaf, tex_leaf, image_size=1024, anti_aliasing=False).sum().backward()

    def rgbad_step():
        face_leaf.grad = tex_leaf.grad = None
        out = rasterize_rgbad(face_leaf, tex_leaf, image_size=1024, anti_aliasing=False)
        (out['rgb'].sum() + out['alpha'].sum() + out['depth'].sum()).backward()

    verts = torch.tensor(v, device=dev)[None].requires_grad_(True)
    faces = torch.tensor(f, device=dev)[None]
    g_n = torch.randn(verts.shape, generator=gen, device=dev)

    def normals():
        verts.grad = None
        (vertex_normals_fn(verts, faces) * g_n).sum().backward()

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({'fixed_order_sums': {
        'tag': args.tag, 'package': str(Path(jrender_tpu_torch.__file__).parent),
        'card': smi.splitlines()[0] if smi else 'not read', 'faces': face.shape[1],
        'drawn_pixels': int((fi >= 0).sum().item()),
        'depth_gradient_ms': timed(lambda: nplain.backward_depth(face, fi, finv, wt, dp, zc,
                                                                 g_depth)),
        'rasterize_step_ms': timed(raster_step),
        'rgbad_step_ms': timed(rgbad_step),
        'vertex_normals_ms': timed(normals)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
