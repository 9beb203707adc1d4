#!/usr/bin/env python3
"""Time the N3MR z-buffer kernel (K12) built with other compile-time
choices, on one CUDA card.

    python3 tools/time_n3mr_maps.py [--builds 1,2] [--turns N]

On ``chip_smoke.py`` phase 9's inputs (the 39,474-face ``uv_sphere(130,
153)`` in front of the camera at 1024 px, 2x2x2 texels a face; the inputs
of ``compare_softras_trees.py``'s ``n3mr`` part), ``csrc/n3mr_maps.cu``
built as each build of ``n3mr.cuda_impl.maps_defines`` names it (the
tiles a cluster pools) is timed on the frame, on the busiest tile's
cluster alone (a grid of that one cluster, on the frame's lists) and on
empty lists (the epilogue and the writes alone), in the
order given and then in reverse, ``--turns`` times over (CUDA events, the
median of 5 rounds of 20 launches after a warm-up; each build's readings
are listed in the order taken, so two builds read in turns give each
turn's difference and their spread).  Registers and spill stores come from
``ptxas -v``; registers, local bytes and blocks an SM from the CUDA
runtime.  Every build's six maps, on the frame, on the busiest tile's
cluster and on empty lists, must equal the default build's bit for bit.  Prints one JSON line
with the card's name and power limit.  Needs a card (exits 2 without one)
and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EPS = 1e-4   # rasterize's default


def ptxas(defines):
    """(registers, spill store bytes) of the build's kernel in its ``ptxas
    -v`` report."""
    from jrender_tpu_torch import _build
    regs = spill = None
    for line in _build.build_log('n3mr_maps', defines).splitlines():
        if 'spill stores' in line:
            spill = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif 'Used' in line and 'registers' in line:
            regs = int(line.split('Used')[1].split('registers')[0])
    return regs, spill


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--builds', default=None,
                    help='comma-separated builds (default: n3mr.cuda_impl.MAPS_BUILDS)')
    ap.add_argument('--turns', type=int, default=1,
                    help='times over the builds in order and in reverse')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_n3mr_maps: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import n3mr_inputs, scene
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.ops.softras import cuda_impl

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    v, f, _, _, gen = scene(torch, dev)
    fv, tex, _ = n3mr_inputs(torch, dev, v, f, gen)
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

    builds = (args.builds.split(',') if args.builds else list(ncuda.MAPS_BUILDS))
    _build.build(['n3mr_maps'] + [('n3mr_maps', ncuda.maps_defines(b)) for b in builds])
    rows = nplain.face_rows(fv, 1024)
    lists = ncuda.tile_lists(fv, 1024)
    busy = int(lists.counts[0].argmax())
    tiles = -(-1024 // ncuda.TILE)
    ty, tx = divmod(busy, tiles)
    empty = lists._replace(run_counts=torch.zeros_like(lists.run_counts),
                           gcount=torch.zeros_like(lists.gcount))
    cases = {'frame': (lists, None), 'busiest cluster': (lists, busy), 'empty lists': (empty, None)}
    want = {'frame': ncuda.launch_maps(rows, lists, tex, 1024, 0.1, 100.0, EPS),
            'empty lists': ncuda.launch_maps(rows, empty, tex, 1024, 0.1, 100.0, EPS)}
    want['busiest cluster'] = want['frame']
    torch.cuda.synchronize()

    def written(b, which):
        """The pixels a launch of build ``b`` writes: the busiest tile's
        cluster (that build's tiles a cluster pools), or all."""
        if which != 'busiest cluster':
            return slice(None), slice(None)
        S = int(b)
        y0 = (ty - ty % S) * ncuda.TILE
        return slice(y0, y0 + S * ncuda.TILE), slice(tx * ncuda.TILE, (tx + 1) * ncuda.TILE)

    times = {}
    for b in (builds + builds[::-1]) * args.turns:
        defines = ncuda.maps_defines(b)
        fn = ncuda.maps_variant(defines)
        for which, (cl, tile) in cases.items():
            a, out = ncuda.maps_args(rows, cl, tex, 1024, 0.1, 100.0, EPS, tile=tile)
            run = lambda a=a: cuda_impl._run(fn, 'n3mr_maps', a, dev)
            run()
            torch.cuda.synchronize()
            ys, xs = written(b, which)
            if not all(torch.equal(x[:, ys, xs], y[:, ys, xs])
                       for x, y in zip(out, want[which])):
                raise AssertionError(f'n3mr_maps build {b}, {which}: maps differ from the '
                                     "default build's")
            times.setdefault((b, which), []).append(timed(run))
    result = {
        'device': smi,
        'default': {'build': ncuda.MAPS_BUILD, **ncuda.maps_occupancy(),
                    'ptxas_registers_spill_stores': ptxas(())},
        'busiest_tile': busy, 'busiest_tile_faces': int(lists.counts[0, busy]),
        'builds': {b: {'frame_ms': times[(b, 'frame')],
                       'busiest_cluster_ms': times[(b, 'busiest cluster')],
                       'busiest_cluster_faces': int(lists.counts[0].reshape(-1, tiles)[
                           ty - ty % int(b):ty - ty % int(b) + int(b), tx].sum()),
                       'empty_lists_ms': times[(b, 'empty lists')],
                       'ptxas_registers_spill_stores': ptxas(ncuda.maps_defines(b)),
                       **ncuda.maps_occupancy(ncuda.maps_defines(b))}
                   for b in builds},
        'maps_equal_across_builds': True}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
