#!/usr/bin/env python3
"""Time N3MR's edge gradient built with bands of 1, 2, 4 and 8 rows, on one
CUDA card: the readings the band height (``n3mr.cuda_impl.EDGE_BAND``, the
kernel's ``N3MR_EDGE_BAND``) was chosen from.

    python3 tools/time_edge_bands.py

On the 39,474-face ``uv_sphere(130, 153)``, demo 1's camera, 2x2x2 texels
per face and a seeded incoming rgb gradient (the inputs of phase 9 of
``chip_smoke.py``), at 1024 px and at 2048 px (the anti-aliased step's
maps), each band height's build (``edgebwd_variant``: its band keys, their
sort and the edge kernels, uncounted) is held against the default build
within ``N3MR_SUM_TOL`` of scale and timed (CUDA events, the median of 5
rounds of 10 calls after a warm-up).  Prints one JSON line: the card's
name and power limit and, per image size and band height, the time in ms
and the items that go to the global list.

Seeded; needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BANDS = (1, 2, 4, 8)
EPS = 1e-4   # rasterize's default


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_edge_bands: no CUDA device', file=sys.stderr)
        return 2
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.transform import look_at, perspective
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, scaled_err
    from jrender_tpu_torch.utils.primitives import uv_sphere

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    # the band heights' builds, one nvcc each, all at once
    _build.build(['n3mr_maps', 'n3mr_edgebwd'] + [
        ('n3mr_edgebwd', (('N3MR_EDGE_BAND', band),)) for band in BANDS if band != ncuda.EDGE_BAND])
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    v, f = uv_sphere(130, 153)
    vt = perspective(look_at(torch.tensor(v, device=dev)[None], (0.0, 0.0, -2.732)), angle=30)
    fv = face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9)
    tex = torch.rand((1, fv.shape[1], 2, 2, 2, 3), generator=gen, device=dev)
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

    out = {}
    for is_ in (1024, 2048):
        _, fi, _, _, _, _, rgb = ncuda.forward_maps(fv, tex, is_, 0.1, 100.0, EPS)
        g_rgb = torch.randn(rgb.shape, generator=gen, device=dev)
        alpha = (fi >= 0).float()
        inputs = ncuda.edge_inputs(fv, fi, rgb, alpha, g_rgb, alpha, is_, True, False)
        want = ncuda.launch_edgebwd(*inputs, EPS, True, False)
        for band in BANDS:
            run = ncuda.edgebwd_variant(band)
            err = scaled_err(run(*inputs, EPS, True, False), want)
            if not err <= N3MR_SUM_TOL:
                raise AssertionError(f'{is_} px, bands of {band} rows: {err} of scale from the '
                                     f'default build (tolerance {N3MR_SUM_TOL})')
            items = ncuda.band_keys_plain(inputs[0], is_, band)[1]
            out[f'{is_}px_band{band}'] = {
                'ms': timed(lambda: run(*inputs, EPS, True, False)),
                'global_items': int((items[:, 2] < 0).sum()), 'max_err_of_scale': err}
    print(json.dumps({'device': smi, 'default_band': ncuda.EDGE_BAND, 'times': out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
