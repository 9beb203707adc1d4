#!/usr/bin/env python3
"""Time the dir route's kernels (K10 forward, K11 backward) on one CUDA card,
the forward with its listed rows staged both ways.

    python3 tools/time_dir.py [--inputs dir_288,dir_3330,dir_39474,dir_demo2]
                              [--spheres 38x45@256,130x153@768]
                              [--k40 dir_288,dir_3330] [--turns N]

On the dir part's inputs of ``compare_softras_trees.py`` (the 288-, 3,330-
and 39,474-face spheres at 1024 px with the renderer's defaults, K = 16,
and demo 2's first step: 120 views at 64 px, 1,300 faces) and on more UV
spheres under the same camera (``--spheres``, rings x segments @ image
size, to read faces of other sizes beside a tile), the forward is timed
alone (its arguments made before the timing, ``dir_impl.fwd_args``) with
its rows staged by the block and by warps with the cull, in turns block,
warp, warp, block, ``--turns`` times over: with the threshold at K = 16,
without it and, on the inputs of ``--k40``, at K = 40 (the bisection).
The backward is timed at K = 16 on the forward's outputs and a seeded
incoming gradient (``dir_impl.bwd_args``).  CUDA events, the median of 5
rounds of 20 launches after a warm-up (4 of 2 at K = 40); each reading is
listed in the order taken.  Both stagings' outputs must be equal bit for
bit (image, aggregates, counts and threshold).  For each input the JSON
line gives its faces, views, image pixels a face and the staging that
``dir_impl.fwd_warp_rows`` picks; registers, local bytes and blocks an SM
of each kernel on the first input come from the CUDA runtime, spill
stores from ``ptxas -v`` (the most of any kernel of the source).  Prints
one JSON line with the card's name and power limit.  Needs a card (exits 2
without one) and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def spill_stores(source: str) -> int:
    """The most spill-store bytes of any kernel in the source's ptxas report."""
    from jrender_tpu_torch import _build
    most = 0
    for line in _build.build_log(source).splitlines():
        if 'spill stores' in line:
            most = max(most, int(line.split('bytes spill stores')[0].split(',')[-1]))
    return most


def sphere_inputs(torch, dev, gen, spec: str):
    """A UV sphere of ``rings x segs @ size`` under the comparison's camera:
    (face vertices, textures, parameters' keywords)."""
    from compare_softras_trees import scene
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.utils.primitives import uv_sphere
    shape, size = spec.split('@')
    rings, segs = (int(n) for n in shape.split('x'))
    v, f = uv_sphere(rings, segs)
    _, _, _, renderer, _ = scene(torch, dev)
    tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                   renderer.transform.eyes))
    return (lit.face_vertices.reshape(1, -1, 9).contiguous(), lit.face_textures.contiguous(),
            dict(image_size=int(size)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--inputs', default='dir_288,dir_3330,dir_39474,dir_demo2',
                    help='comma-separated inputs of the dir part')
    ap.add_argument('--spheres', default='',
                    help='comma-separated more spheres, rings x segments @ image size')
    ap.add_argument('--k40', default='', help='comma-separated inputs also timed at K = 40')
    ap.add_argument('--turns', type=int, default=1,
                    help='times over block, warp, warp, block')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_dir: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import dir_inputs
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import cuda_impl, dir_impl, make_params

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    _build.build(['softras_dir_prep', 'softras_dir_fwd', 'softras_dir_bwd'])
    gen = torch.Generator(device=dev).manual_seed(13)
    common = dir_inputs(torch, dev, gen)
    keys = [k for k in args.inputs.split(',') if k]
    for spec in (s for s in args.spheres.split(',') if s):
        fv, tex, kw = sphere_inputs(torch, dev, gen, spec)
        p = make_params(**kw)
        img, ag, _, thr = dir_impl.launch_dir_fwd(dir_impl.prep_dir(fv, tex, p), p, True)
        common[spec] = (fv, tex, kw, img, ag, thr,
                        torch.randn(img.shape, generator=gen, device=dev))
        keys.append(spec)
    k40 = {k for k in args.k40.split(',') if k}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, reps=20, rounds=5):
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

    def same(got, want):
        return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))

    fwd = cuda_impl._entry('softras_dir_fwd', 'softras_dir_fwd', dir_impl._DirFwdArgs)
    times, inputs, occupancy = {}, {}, {}
    for key in keys:
        fv, tex, kw, img, ag, thr, g = common[key]
        p = make_params(**kw)
        table = dir_impl.prep_dir(fv, tex, p, for_grad=True)
        B, F = table.ids.shape
        is_ = p.image_size
        inputs[key] = {'faces': F, 'views': B, 'image_size': is_,
                       'pixels_a_face': is_ * is_ / F,
                       'rule': 'warp' if dir_impl.fwd_warp_rows(F, is_) else 'block',
                       'bwd_items': dir_impl.item_count(table.items)}
        cases = [('thr', p, True), ('nothr', p, False)]
        if key in k40:
            cases.append(('k40', dataclasses.replace(p, max_faces_id=40), True))
        for what, pp, with_thr in cases:
            want = None
            for _ in range(args.turns):
                for rows in ('block', 'warp', 'warp', 'block'):
                    a, out = dir_impl.fwd_args(table, pp, with_thr, rows == 'warp')
                    run = lambda a=a: cuda_impl._run(fwd, 'softras_dir_fwd', a, dev)
                    run()
                    torch.cuda.synchronize()
                    if want is None:
                        want = tuple(x.clone() if x is not None else None for x in out)
                    elif not same(out, want):
                        raise AssertionError(f'{key} {what}: the rows staged by the block and '
                                             'by warps give other outputs')
                    big = what == 'k40'
                    times.setdefault(f'fwd {key} {what} {rows}', []).append(
                        timed(run, reps=2 if big else 20, rounds=4 if big else 5))
                    if key == keys[0] and what == 'thr':
                        occupancy.setdefault(f'fwd {rows}', dir_impl.fwd_occupancy(a))
        for _ in range(args.turns):
            a, out = dir_impl.bwd_args(table, img, ag, thr, g, p)
            bwd = cuda_impl._entry('softras_dir_bwd', 'softras_dir_bwd', dir_impl._DirBwdArgs)
            times.setdefault(f'bwd {key} k16', []).append(
                timed(lambda: cuda_impl._run(bwd, 'softras_dir_bwd', a, dev)))
            if key == keys[0]:
                occupancy.setdefault('bwd', dir_impl.bwd_occupancy(a))
    for kind in ('fwd', 'bwd'):
        occupancy[f'{kind} ptxas_spill_stores'] = spill_stores(f'softras_dir_{kind}')
    print(json.dumps({'device': smi, 'inputs': inputs, 'times_ms': times,
                      'occupancy': occupancy, 'stagings_bit_equal': True}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
