#!/usr/bin/env python3
"""Time the f_px (K4), px_f (K6) and pxg (K9) backwards built with other
compile-time choices and cut into other work items, on one CUDA card.

    python3 tools/time_tile_bwd.py [--builds 000,301,...] [--groups 8,16,32,64,128]
                                   [--turns N] [--routes fpx,pxf,pxg]

On the 39,474-face ``uv_sphere(130, 153)`` at 1024 px, demo 1's camera at
45 degrees, 5x5 texels a face, the renderer's defaults (K4 at
``grad_mode='full'``, K6 and K9 with the forward's threshold at K = 16), a
seeded incoming gradient: each build of ``csrc/softras_tile_bwd.cuh`` is
timed on the frame and on the busiest tile alone (f_px, px_f: its faces
alone; pxg: its work items on the frame's inputs), at the route's work-item
size, in the order given and then in reverse, ``--turns`` times over (CUDA
events, the median of 5 rounds of 20 launches after a warm-up; each
build's readings are listed in the order taken, so two builds read in
turns give each turn's difference and their spread).  A build is three
digits: SOFTRAS_TILE_BWD_MIN_BLOCKS (the register cap; 0: none), _ROWS
(each warp stages its own faces' rows with cp.async and takes the item's
next face from a counter) and _TEXEL (the texel adds in rounds); 000 is
none of them.  Every build is also timed at each work-item size of
``--groups`` (faces an item at most; ``tiled.prep(..., group)``, pxg:
``prep_pxg(..., group)``; empty: none), and the default build with vertex
colours (``texture_type='vertex'``: register sums, no texel adds) beside
surface T = 25.
Registers and spill stores come from ``ptxas -v`` for every distance
(hard, barycentric, euclidean) with surface texels and with vertex
colours, blocks an SM from the CUDA runtime; every build's rows, on the
frame, on the busiest tile and at every item size, must equal the
default build's bit for bit.  Prints one JSON line with the card's name
and power limit.  Needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BUILDS = '000,200,300,400,010,001,211,311,411,301,401,310'
DISTS = {'hard': 0, 'barycentric': 1, 'euclidean': 2}   # kDist* of softras_pair.cuh


def ptxas(source, defines):
    """{distance: {'surface' | 'vertex': (registers, spill store bytes)}}
    of every kernel in the build's ``ptxas -v`` report."""
    from jrender_tpu_torch import _build
    out = {d: {} for d in DISTS}
    fn = ''
    regs, spill = {}, {}
    for line in _build.build_log(source, defines).splitlines():
        if 'Compiling entry function' in line:
            fn = line.split("'")[1]
        elif 'spill stores' in line:
            spill[fn] = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif 'Used' in line and 'registers' in line:
            regs[fn] = int(line.split('Used')[1].split('registers')[0])
    for d, i in DISTS.items():
        for kind, surface in (('surface', 1), ('vertex', 0)):
            want = f'softras_tile_bwd_kernelILi{i}ELb{surface}E'
            fn = next((f for f in regs if want in f), None)
            out[d][kind] = (regs.get(fn), spill.get(fn))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--builds', default=BUILDS)
    ap.add_argument('--groups', default='8,16,32,64,128')
    ap.add_argument('--turns', type=int, default=1,
                    help='times over the builds in order and in reverse')
    ap.add_argument('--routes', default='fpx,pxf,pxg')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_tile_bwd: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import scene
    from jrender_tpu_torch import Mesh, _build
    from jrender_tpu_torch.ops.softras import (cuda_impl, fpx_impl, make_params, pxf_impl,
                                               pxg_impl, tiled)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    v, f, tex, renderer, gen = scene(torch, dev)
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                   renderer.transform.eyes))
    fv = lit.face_vertices.reshape(1, -1, 9).contiguous()
    tex = lit.face_textures.contiguous()
    tex_v = torch.rand((1, fv.shape[1], 3, 3), generator=gen, device=dev)
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

    builds = args.builds.split(',')
    groups = [int(g) for g in args.groups.split(',') if g]
    routes = args.routes.split(',')
    sources = [f'softras_{r}_bwd' for r in routes]
    _build.build([s for s in sources]
                 + [(s, tiled.bwd_defines(b)) for s in sources for b in builds])

    def case(name, p, fv_, tex_, group):
        """The route's prep at ``group`` faces an item and its forward's
        outputs with a seeded incoming gradient: (pin, images, aggrs, thr,
        grad); pxg's pin is the backward's view, its forward the one at the
        route's own items (K7's partials, and so the image's last bits,
        follow the cut)."""
        if name == 'pxg':
            pin = pxg_impl.prep_pxg(fv_, tex_, p, for_grad=True, group=group)
            own = pin if group == pxg_impl.GROUP else pxg_impl.prep_pxg(fv_, tex_, p)
            img, ag, _, thr = pxg_impl.forward(own, p, True)
            g = torch.randn(img.shape, generator=torch.Generator(device=dev).manual_seed(7),
                            device=dev)
            return pxg_impl.bwd_view(pin, p), img, ag, thr, g
        th, tw = fpx_impl.tile_shape(1024) if name == 'fpx' else (pxf_impl.tile_for(1024),) * 2
        pin = tiled.prep(fv_, tex_, p, th, tw, group, for_grad=True)
        if name == 'fpx':
            img, ag, _, thr = fpx_impl.launch_fpx_fwd(pin, p)
        else:
            img, ag, _, thr = pxf_impl.launch_pxf_fwd(pin, p, True)
        g = torch.randn(img.shape, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
        return pin, img, ag, thr, g

    result = {'device': smi, 'routes': {}}
    for name in routes:
        source = f'softras_{name}_bwd'
        impl = {'fpx': fpx_impl, 'pxf': pxf_impl, 'pxg': pxg_impl}[name]
        kw = dict(image_size=1024, grad_mode='full') if name == 'fpx' else dict(image_size=1024)
        p = make_params(**kw)
        frame = case(name, p, fv, tex, impl.GROUP)
        pin = frame[0]
        sizes = pin.tile_off[1:] - pin.tile_off[:-1]
        busy = int(sizes.argmax())
        lo, hi = int(pin.tile_off[busy]), int(pin.tile_off[busy + 1])
        ids = pin.entries[lo:hi].long()
        if name == 'pxg':
            # the busiest tile's items alone, on the frame's inputs: only its
            # entries' rows are written
            alone = pin._replace(items=pin.items[pin.items[:, 0] == busy].contiguous())
            cases = {'frame': frame, 'busiest tile': (alone, *frame[1:])}
            keep = {'busiest tile': slice(lo, hi)}
        else:
            cases = {'frame': frame,
                     'busiest tile': case(name, p, fv[:, ids].contiguous(),
                                          tex[:, ids].contiguous(), impl.GROUP)}
            keep = {}
        cases.update({f'group {g}': case(name, p, fv, tex, g) for g in groups})
        want = {which: tiled.launch_bwd(source, *c[:4], c[4], p)[keep.get(which, slice(None))]
                for which, c in cases.items()}
        torch.cuda.synchronize()
        for g in groups:
            if not torch.equal(want[f'group {g}'], want['frame']):
                raise AssertionError(f'{source}: the rows of items of {g} faces differ from '
                                     f'those of items of {impl.GROUP}')
        times = {}
        occupancy = {}
        for b in (builds + builds[::-1]) * args.turns:
            defines = tiled.bwd_defines(b)
            fn = tiled.bwd_variant(source, defines)
            for which, (pin_c, img, ag, thr, g) in cases.items():
                a, rows = tiled.bwd_args(pin_c, img, ag, thr, g, p)
                run = lambda fn=fn, a=a: cuda_impl._run(fn, source, a, dev)
                run()
                torch.cuda.synchronize()
                rows = rows[keep.get(which, slice(None))]
                if not torch.equal(rows, want[which]):
                    bad = (rows != want[which]).any(dim=1).float().mean().item()
                    raise AssertionError(f'{source} build {b}, {which}: rows differ from the '
                                         f"default build's ({bad:.6f} of the entries)")
                times.setdefault(f'{b} {which}', []).append(timed(run))
                if which == 'frame':
                    occupancy[b] = tiled.bwd_occupancy(source, a, defines)
        # vertex colours against surface T = 25, default build and 000
        p_v = make_params(texture_type='vertex', **kw)
        vert = case(name, p_v, fv, tex_v, impl.GROUP)
        colours = {}
        for b in ('default', '000'):
            fn = tiled.bwd_variant(source, () if b == 'default' else tiled.bwd_defines(b))
            for tag, (c, pp) in (('vertex', (vert, p_v)), ('surface T=25', (frame, p))):
                a, _ = tiled.bwd_args(*c[:4], c[4], pp)
                colours[f'{b} {tag}'] = timed(lambda fn=fn, a=a: cuda_impl._run(fn, source, a,
                                                                                dev))
        a_def, _ = tiled.bwd_args(*frame[:4], frame[4], p)
        result['routes'][name] = {
            'default': {'group': impl.GROUP, 'items': int(pin.items.shape[0]),
                        'entries': int(pin.entries.numel()),
                        **tiled.bwd_occupancy(source, a_def),
                        'ptxas_registers_spill_stores': ptxas(source, ())},
            'busiest_tile_faces': ids.numel(),
            'busiest_tile_items': int(cases['busiest tile'][0].items.shape[0]),
            'items_by_group': {g: int(cases[f'group {g}'][0].items.shape[0]) for g in groups},
            'builds': {b: {'frame_ms': times[f'{b} frame'],
                           'busiest_tile_ms': times[f'{b} busiest tile'],
                           'frame_ms_by_group': {g: times[f'{b} group {g}'] for g in groups},
                           'ptxas_registers_spill_stores': ptxas(source, tiled.bwd_defines(b)),
                           **occupancy[b]}
                       for b in builds},
            'vertex_vs_surface_ms': colours,
            'rows_equal_across_builds_and_groups': True}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
