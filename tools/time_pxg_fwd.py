#!/usr/bin/env python3
"""Time the pxg partials kernel (K7) built with other register caps, on
one CUDA card.

    python3 tools/time_pxg_fwd.py [--caps 0,2,3,4,5] [--turns N]

On the 39,474-face ``uv_sphere(130, 153)`` at 1024 px, demo 1's camera at
45 degrees, 5x5 texels a face, the renderer's defaults (K = 16), the pxg
route's work items of ``pxg_impl.GROUP`` faces: ``csrc/softras_pxg_fwd.cu``
built at each register cap (SOFTRAS_PXG_FWD_MIN_BLOCKS, blocks an SM; 0:
no cap; ``pxg_impl.fwd_defines``) is timed with and without the depth
lists, on the frame and on the busiest tile's work items alone (on the
frame's inputs), in the order given and then in reverse, ``--turns`` times
over (CUDA events, the median of 5 rounds of 20 launches after a warm-up;
each build's readings are listed in the order taken, so two builds read in
turns give each turn's difference and their spread).  Registers and spill
stores come from ``ptxas -v`` for every distance, softmax rgb with and
without the depth lists; registers, local bytes (the thread's local frame:
spill slots and stack) and blocks an SM from the CUDA runtime.  Every
build's partial rows and depth lists, on the frame and the busiest tile,
must equal the default build's bit for bit.  Prints one JSON line with the
card's name and power limit.  Needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CAPS = '0,2,3,4,5'
DISTS = {'hard': 0, 'barycentric': 1, 'euclidean': 2}   # kDist* of softras_pair.cuh
SOFTMAX = 1                                             # kRgbSoftmax


def ptxas(defines):
    """{distance: {'lists' | 'no lists': (registers, spill store bytes)}} of
    the softmax kernels in the build's ``ptxas -v`` report."""
    from jrender_tpu_torch import _build
    fn = ''
    regs, spill = {}, {}
    for line in _build.build_log('softras_pxg_fwd', defines).splitlines():
        if 'Compiling entry function' in line:
            fn = line.split("'")[1]
        elif 'spill stores' in line:
            spill[fn] = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif 'Used' in line and 'registers' in line:
            regs[fn] = int(line.split('Used')[1].split('registers')[0])
    out = {}
    for d, i in DISTS.items():
        out[d] = {}
        for kind, thr in (('lists', 1), ('no lists', 0)):
            want = f'softras_pxg_fwd_kernelILi{i}ELi{SOFTMAX}ELb{thr}E'
            fn = next((f for f in regs if want in f), None)
            out[d][kind] = (regs.get(fn), spill.get(fn))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--caps', default=CAPS)
    ap.add_argument('--turns', type=int, default=1,
                    help='times over the builds in order and in reverse')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_pxg_fwd: no CUDA device', file=sys.stderr)
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

    builds = [int(c) for c in args.caps.split(',')]
    _build.build(['softras_pxg_fwd'] + [('softras_pxg_fwd', pxg_impl.fwd_defines(b))
                                        for b in builds])
    p = make_params(image_size=1024)
    pin = pxg_impl.prep_pxg(fv, tex, p)
    busy = int((pin.tile_off[1:] - pin.tile_off[:-1]).argmax())
    cases = {'frame': pin,
             'busiest tile': pin._replace(items=pin.items[pin.items[:, 0] == busy].contiguous())}
    want = {(which, lists): pxg_impl.launch_pxg_fwd(c, p, lists)
            for which, c in cases.items() for lists in (True, False)}
    torch.cuda.synchronize()

    times, occupancy = {}, {}
    for b in (builds + builds[::-1]) * args.turns:
        defines = pxg_impl.fwd_defines(b)
        fn = pxg_impl.fwd_variant(defines)
        for (which, lists), (w_parts, w_depths) in want.items():
            a, (parts, depths) = pxg_impl.fwd_args(cases[which], p, lists)
            run = lambda a=a: cuda_impl._run(fn, 'softras_pxg_fwd', a, dev)
            run()
            torch.cuda.synchronize()
            if not torch.equal(parts, w_parts) or (lists and not torch.equal(depths, w_depths)):
                raise AssertionError(f'softras_pxg_fwd at cap {b}, {which}, depth lists {lists}: '
                                     "partial rows or depth lists differ from the default "
                                     "build's")
            tag = f'{b} {which}' + ('' if lists else ' no lists')
            times.setdefault(tag, []).append(timed(run))
            if which == 'frame':
                occupancy[(b, lists)] = pxg_impl.fwd_occupancy(a, defines)
    a_def, _ = pxg_impl.fwd_args(pin, p, True)
    result = {
        'device': smi,
        'default': {'group': pxg_impl.GROUP, 'items': int(pin.items.shape[0]),
                    'chunk': cuda_impl.chunk_for(pin.rows.shape[-1]),
                    **pxg_impl.fwd_occupancy(a_def),
                    'ptxas_registers_spill_stores': ptxas(())},
        'busiest_tile_faces': int(pin.tile_off[busy + 1] - pin.tile_off[busy]),
        'busiest_tile_items': int(cases['busiest tile'].items.shape[0]),
        'builds': {b: {'frame_ms': times[f'{b} frame'],
                       'frame_no_lists_ms': times[f'{b} frame no lists'],
                       'busiest_tile_ms': times[f'{b} busiest tile'],
                       'busiest_tile_no_lists_ms': times[f'{b} busiest tile no lists'],
                       'ptxas_registers_spill_stores': ptxas(pxg_impl.fwd_defines(b)),
                       'occupancy_lists': occupancy[(b, True)],
                       'occupancy_no_lists': occupancy[(b, False)]}
                   for b in builds},
        'parts_and_lists_equal_across_builds': True}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
