#!/usr/bin/env python3
"""Time the pxg threshold kernel (K8) built with other compile-time
choices, on one CUDA card.

    python3 tools/time_pxg_thr.py [--builds 1,2,4] [--turns N]

On the 39,474-face ``uv_sphere(130, 153)`` at 1024 px, demo 1's camera at
45 degrees, 5x5 texels a face, the renderer's defaults (K = 16), the pxg
route's work items (the inputs of ``compare_softras_trees.py``'s ``pxg``
part), ``csrc/softras_pxg_thr.cu`` built as each build of
``pxg_impl.thr_defines`` names it (threads a pixel in the bisection) is
timed alone (its arguments made before the timing, ``pxg_impl.thr_args``) on the frame, on the
overfull tile of the most work items alone, and at K = 40 (the
bisection), in the order given and then in reverse, ``--turns`` times
over (CUDA events, the median of 5 rounds of 20 launches after a warm-up,
5 launches at K = 40; each build's readings are listed in the order
taken).  Beside them, once: the wrapper (``launch_pxg_thr``, the default
build with its argument checks and allocation) and the yardstick
``torch.kthvalue`` on the overfull tiles' lists already gathered
([tiles, items x K, 256]; the gather is not timed).  Registers and spill
stores come from ``ptxas -v`` for the lists' kernel and the bisection's at
every distance; registers, local bytes and blocks an SM of the lists'
kernel from the CUDA runtime.  Every build's map at K = 16 and
40 must equal the default build's bit for bit, and the default's must
equal the plain merge (``thr_plain``).  Prints one JSON line with the
card's name and power limit.  Needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DISTS = {'hard': 0, 'barycentric': 1, 'euclidean': 2}   # kDist* of softras_pair.cuh


def ptxas(defines):
    """{'lists' | distance of the bisection: (registers, spill store bytes)}
    of the build's kernels in its ``ptxas -v`` report."""
    from jrender_tpu_torch import _build
    fn = ''
    regs, spill = {}, {}
    for line in _build.build_log('softras_pxg_thr', defines).splitlines():
        if 'Compiling entry function' in line:
            fn = line.split("'")[1]
        elif 'spill stores' in line:
            spill[fn] = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif 'Used' in line and 'registers' in line:
            regs[fn] = int(line.split('Used')[1].split('registers')[0])
    out = {}
    for d, want in [('lists', 'softras_pxg_thr_lists_kernel')] + [
            (d, f'softras_pxg_thr_bisect_kernelILi{i}E') for d, i in DISTS.items()]:
        fn = next((f for f in regs if want in f), None)
        out[d] = (regs.get(fn), spill.get(fn))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--builds', default=None,
                    help='comma-separated builds (default: pxg_impl.THR_BUILDS)')
    ap.add_argument('--turns', type=int, default=1,
                    help='times over the builds in order and in reverse')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_pxg_thr: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import scene
    from jrender_tpu_torch import Mesh, _build
    from jrender_tpu_torch.ops.softras import cuda_impl, make_params, pxg_impl

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

    builds = args.builds.split(',') if args.builds else list(pxg_impl.THR_BUILDS)
    _build.build(['softras_pxg_thr'] + [('softras_pxg_thr', pxg_impl.thr_defines(b))
                                        for b in builds])
    p = make_params(image_size=1024)
    p40 = dataclasses.replace(p, max_faces_id=40)
    pin = pxg_impl.prep_pxg(fv, tex, p)
    parts, depths = pxg_impl.launch_pxg_fwd(pin, p, True)
    _, _, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
    n_it = (pin.item_off[1:] - pin.item_off[:-1]).long()
    over = pxg_impl.overfull_tiles(pin, cnt, p).long()
    busy = int(over[n_it[over].argmax()])
    want = pxg_impl.launch_pxg_thr(pin, depths, cnt, p)
    want40 = pxg_impl.launch_pxg_thr(pin, None, cnt, p40)
    if not torch.equal(want, pxg_impl.thr_plain(pin, depths, cnt, p)):
        raise AssertionError('softras_pxg_thr: the default build differs from thr_plain')
    cases = {'frame': (p, depths, want, (), 20), 'busiest tile': (p, depths, None, (busy, 1), 20),
             'k40': (p40, None, want40, (), 5)}

    times, occupancy = {}, {}
    for b in (builds + builds[::-1]) * args.turns:
        defines = pxg_impl.thr_defines(b)
        fn = pxg_impl.thr_variant(defines)
        for which, (pp, dd, w, tiles, reps) in cases.items():
            a, thr = pxg_impl.thr_args(pin, dd, cnt, pp, *tiles)
            run = lambda a=a: cuda_impl._run(fn, 'softras_pxg_thr', a, dev)
            run()
            torch.cuda.synchronize()
            if w is not None and not torch.equal(thr, w):
                raise AssertionError(f'softras_pxg_thr build {b}, {which}: the map differs '
                                     "from the default build's")
            times.setdefault((b, which), []).append(timed(run, reps=reps))
            if which == 'frame':
                occupancy[b] = pxg_impl.thr_occupancy(a, defines)
    # once: the wrapper, and torch.kthvalue on the overfull tiles' gathered lists
    L, ok = pxg_impl._by_tile(pin, depths, over)
    L = torch.where(ok[:, :, None, None], L, float('inf')).reshape(over.numel(), -1, 256)
    result = {
        'device': smi,
        'default': {'build': pxg_impl.THR_BUILD,
                    **pxg_impl.thr_occupancy(pxg_impl.thr_args(pin, depths, cnt, p)[0]),
                    'ptxas_registers_spill_stores': ptxas(())},
        'wrapper_ms': timed(lambda: pxg_impl.launch_pxg_thr(pin, depths, cnt, p)),
        'kthvalue_ms': timed(lambda: torch.kthvalue(L, p.max_faces_id, dim=1)),
        'overfull_tiles': over.numel(), 'busiest_tile': busy,
        'busiest_tile_items': int(n_it[busy]),
        'builds': {b: {'frame_ms': times[(b, 'frame')],
                       'busiest_tile_ms': times[(b, 'busiest tile')],
                       'k40_ms': times[(b, 'k40')],
                       'ptxas_registers_spill_stores': ptxas(pxg_impl.thr_defines(b)),
                       'occupancy': occupancy[b]}
                   for b in builds},
        'maps_equal_across_builds': True}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
