#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 alone on one CUDA card: the parallel stack
(``chip_smoke.parallel_stack``).

    python3 tools/run_parallel_phase.py

The bands of bench.py's 1024-px sphere (39,474 faces, T = 25, K = 16, the
inputs of ``chip_smoke.py`` phase 5) against the whole image, the band
kernels against their plain versions at 128 and 256 px, the sharded path
through a one-rank NCCL group against ``soft_rasterize`` (both layouts),
the band balance of 4 bands (device time of K1, its threshold and K2 on
each band, strided and contiguous) and the sharded NeRF step at the lego
config's widths, with the same checks as ``chip_smoke.py``.  Builds the
kernels it runs (about a minute).  Prints phase 17's log lines and one JSON
line of its numbers beside the card's name and power limit; exits 1 when
a check fails.  Phase 16b's NeRF step time, which ``chip_smoke.py`` prints
beside 17d's, is not measured here.

Needs a card (exits 2 without one).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('run_parallel_phase: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    from jrender_tpu_torch import Mesh, Renderer, _build
    from jrender_tpu_torch.ops import segment_sum
    from jrender_tpu_torch.ops.softras import cuda_impl, fpx_impl, make_params, pxf_impl
    from jrender_tpu_torch.utils.primitives import uv_sphere

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    C.log(f'{torch.cuda.get_device_name(0)}  torch {torch.__version__} cuda {torch.version.cuda}')
    C.log(smi)
    t0 = time.time()
    _build.build(['softras_fwd', 'softras_thr', 'softras_bwd', 'softras_pxf_fwd',
                  'softras_pxf_bwd', 'segment_sum'])
    C.log(f'build: {time.time() - t0:.1f} s')
    dev = torch.device('cuda')
    # chip_smoke.py phase 4's frame 1: the 39,474-face sphere lit and projected
    v, f = uv_sphere(130, 153)
    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
    mesh = Mesh(v, f, textures=tex, texture_res=5, texture_type='surface')
    renderer = Renderer(image_size=1024)
    renderer.transform.set_eyes_from_angles(2.732, 30, 1 * 360 // C.FRAMES)
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(mesh, renderer.transform.eyes))
    wrappers = {'softras_fwd': cuda_impl.launch, 'softras_thr': cuda_impl.launch_thr,
                'softras_bwd': cuda_impl.launch_bwd, 'softras_bwd_reduce': cuda_impl.launch_reduce}
    tiled = {'softras_fpx_fwd': fpx_impl.launch_fpx_fwd, 'softras_fpx_bwd': fpx_impl.launch_fpx_bwd,
             'softras_pxf_fwd': pxf_impl.launch_pxf_fwd, 'softras_pxf_bwd': pxf_impl.launch_pxf_bwd}

    def zero_counts():
        for w in (*wrappers.values(), *tiled.values(), segment_sum.launch_segment_sum):
            w.launches = 0

    t0 = time.time()
    out = C.parallel_stack(dict(
        dev=dev, smi=smi, fv=lit.face_vertices.reshape(1, -1, 9).contiguous(),
        tex=lit.face_textures.contiguous(), p=make_params(image_size=1024),
        zero_counts=zero_counts, read_counts=lambda: {k: w.launches for k, w in wrappers.items()},
        read_tiled=lambda: {k: w.launches for k, w in tiled.items()}, nerf_ms=None))
    C.log(json.dumps({'phase17': out, 'seconds': time.time() - t0, 'card': smi}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
