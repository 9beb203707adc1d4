#!/usr/bin/env python3
"""Time the f_px (K3) and px_f (K5) forwards built with other compile-time
constants, on one CUDA card.

    python3 tools/time_tile_fwd.py [--splits 2,4,8] [--min-blocks 1,2,3,4]

On the 39,474-face ``uv_sphere(130, 153)`` at 1024 px, demo 1's camera at
45 degrees, 5x5 texels a face, the renderer's defaults (K3 at
``grad_mode='full'``, K5 with its threshold at K = 16), each build of
``csrc/softras_tile_fwd.cuh`` (SOFTRAS_TILE_SPLIT blocks per tile x
SOFTRAS_TILE_MIN_BLOCKS, the register cap of its ``__launch_bounds__``) is
timed on the frame and on the busiest tile's faces alone (CUDA events, the
median of 5 rounds of 20 launches after a warm-up), in the order given and
then in reverse; its registers and spills come from ``ptxas -v``, and its
counts and thresholds must equal the default build's bit for bit.  Prints
one JSON line with the card's name and power limit.  Needs a card (exits 2
without one) and nvcc.
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
    ap.add_argument('--splits', default='2,4,8')
    ap.add_argument('--min-blocks', default='1,2,3,4')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_tile_fwd: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import scene
    from jrender_tpu_torch import Mesh, _build
    from jrender_tpu_torch.ops.softras import (cuda_impl, fpx_impl, make_params, pxf_impl,
                                               tiled)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    v, f, tex, renderer, _ = scene(torch, dev)
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                   renderer.transform.eyes))
    fv = lit.face_vertices.reshape(1, -1, 9).contiguous()
    tex = lit.face_textures.contiguous()
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

    routes = {}
    for name in ('fpx', 'pxf'):
        if name == 'fpx':
            p = make_params(image_size=1024, grad_mode='full')
            prep = lambda f_, t_, p=p: fpx_impl.prep_fpx(f_, t_, p)
        else:
            p = make_params(image_size=1024)
            prep = lambda f_, t_, p=p: pxf_impl.prep_pxf(f_, t_, p)
        pin = prep(fv, tex)
        sizes = pin.tile_off[1:] - pin.tile_off[:-1]
        busy = int(sizes.argmax())
        ids = pin.entries[int(pin.tile_off[busy]):int(pin.tile_off[busy + 1])].long()
        routes[name] = (p, {'frame': pin, 'busiest tile': prep(fv[:, ids].contiguous(),
                                                             tex[:, ids].contiguous())})

    splits = [int(s) for s in args.splits.split(',')]
    min_blocks = [int(m) for m in args.min_blocks.split(',')]
    builds = [(S, m) for S in splits for m in min_blocks]
    _build.build([(f'softras_{n}_fwd', (('SOFTRAS_TILE_SPLIT', S), ('SOFTRAS_TILE_MIN_BLOCKS', m)))
                  for n in routes for S, m in builds])

    def ptxas(source, defines):
        """(registers, spill store bytes) of the route's main kernel: the
        euclidean distance, softmax rgb, K5's K-smallest lists."""
        want = f'softras_tile_fwd_kernelILi2ELi1ELi{1 if source == "softras_pxf_fwd" else 0}E'
        fn, spill = '', None
        for line in _build.build_log(source, defines).splitlines():
            if 'Compiling entry function' in line:
                fn = line.split("'")[1]
            elif want in fn and 'spill stores' in line:
                spill = int(line.split('bytes spill stores')[0].split(',')[-1])
            elif want in fn and 'Used' in line and 'registers' in line:
                return int(line.split('Used')[1].split('registers')[0]), spill
        return None, None

    result = {'device': smi, 'builds': {}}
    for name, (p, pins) in routes.items():
        source = f'softras_{name}_fwd'
        with_thr = name == 'pxf'
        bounds = pxf_impl.thr_bisect_bounds(p.near, p.far) if with_thr else (0, 0, 0)
        want = tiled.launch_fwd(source, pins['frame'], p, with_thr, bounds)
        times = {}
        for S, m in builds + builds[::-1]:
            defines = (('SOFTRAS_TILE_MIN_BLOCKS', m),)
            fn = tiled.split_variant(source, S, defines)
            for which, pin in pins.items():
                a, out = tiled.fwd_args(pin, p, with_thr, bounds)
                run = lambda fn=fn, a=a: cuda_impl._run(fn, source, a, dev)
                run()
                torch.cuda.synchronize()
                if which == 'frame' and not (torch.equal(out[2], want[2]) and (
                        not with_thr or torch.equal(out[3], want[3]))):
                    raise AssertionError(f'{source} at {S} blocks per tile, min blocks {m}: '
                                         'counts or thresholds differ from the default build')
                times.setdefault(f'{S} {m} {which}', []).append(timed(run))
        result['builds'][name] = {
            f'split {S}, min blocks {m}': {
                'frame_ms': times[f'{S} {m} frame'],
                'busiest_tile_ms': times[f'{S} {m} busiest tile'],
                'registers_spill_stores': ptxas(
                    source, (('SOFTRAS_TILE_SPLIT', S), ('SOFTRAS_TILE_MIN_BLOCKS', m)))}
            for S, m in builds}
        result['builds'][name]['busiest_tile_faces'] = int(
            pins['busiest tile'].rows.shape[1])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
