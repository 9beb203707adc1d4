#!/usr/bin/env python3
"""Time the N3MR texture gradient (K13, csrc/n3mr_texbwd.cu) and the binned
SoftRas face reduction (csrc/softras_bwd.cu ``softras_bwd_reduce``) alone
on one CUDA card, by the kernels' own device time.

    python3 tools/time_texbwd_reduce.py [--turns N]

Inputs: K13 on the forward maps of the 39,474-face ``uv_sphere(130, 153)``
at 1024 px (``chip_smoke.py`` phase 9's camera) at texture sizes 2 and 4, of
the 288- and 3,330-face spheres at size 2, and of demo 4's first fit step
(256 px, size 4); the reduction on the slot rows of the binned backward on
the 39,474-, 288- and 3,330-face spheres at 1024 px (5x5 texels, K = 16)
and of demo 2's first step (120 views at 64 px, T = 1).  Each kernel is
launched on arguments made once (``texbwd_args``, ``reduce_args``) and its
device time read with torch.profiler (``jrender_tpu_torch/utils/
device_time.py``: the median over 20 launches), ``--turns`` times.  Both
run twice, bit-equal, and against their plain versions (K13 within
``N3MR_SUM_TOL`` of the largest entry, the reduction bit-equal).  Prints
one JSON line: the card, the times by input, K13's registers and blocks an
SM by texture size, the reduction's slot rows, and the checks; exits 1
when a check fails.  (PERF.md's
readings of the two kernels' design elements were taken by this script
with build switches that the measurements then removed.)

Needs a card (exits 2 without one) and nvcc.
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
    ap.add_argument('--turns', type=int, default=2, help='readings of each kernel and input')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('time_texbwd_reduce: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    from compare_softras_trees import demo4_maps, reduce_inputs, scene, sphere_maps
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.ops.softras import cuda_impl, make_params
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, scaled_err
    from jrender_tpu_torch.utils.device_time import device_ms
    from jrender_tpu_torch.utils.primitives import uv_sphere

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(14)

    # K13's inputs: (rows, face_index, weight, depth, zcorn, grad_rgb, eps), sizes
    tex_in = {f'sphere_{F}': (sphere_maps(torch, dev, *uv_sphere(*rs), gen), sizes)
              for F, rs, sizes in ((39474, (130, 153), (2, 4)), (288, (13, 12), (2,)),
                                   (3330, (38, 45), (2,)))}
    tex_in['demo4'] = (demo4_maps(torch, dev), (4,))
    k13_cases = {}
    for key, ((rows, fi, wt, dp, zc, g, eps), sizes) in tex_in.items():
        for ts in sizes:
            a = ncuda.texbwd_args(rows, (*rows.shape[:2], ts, ts, ts, 3), fi, wt, dp, zc, g, eps)
            k13_cases[f'{key}_ts{ts}'] = a
    # the reduction's inputs: slot rows of the default backward, then args
    red_in = reduce_inputs(torch, dev)
    v, f, tex, renderer, _ = scene(torch, dev)
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                   renderer.transform.eyes))
    red_in['red_39474'] = (lit.face_vertices.reshape(1, -1, 9).contiguous(),
                           lit.face_textures.contiguous(), dict(image_size=1024))
    red_cases = {}
    for key, (fv, tx, kw) in red_in.items():
        p = make_params(**kw)
        inp = cuda_impl.prepare(fv, tx, p, for_grad=True)
        img, ag, cnt = cuda_impl.launch(inp, p)
        thr = cuda_impl.topk_threshold(fv, p, inp, cnt)
        rows = cuda_impl.launch_bwd(inp, img, ag, thr, torch.ones_like(img), p)
        red_cases[key] = (inp, rows, p)
    torch.cuda.synchronize()

    k13_fn = cuda_impl._entry('n3mr_texbwd', 'n3mr_texbwd', ncuda._TexBwdArgs)
    red_fn = cuda_impl._entry('softras_bwd', 'softras_bwd_reduce', cuda_impl._ReduceArgs)
    checks, times = {}, {}
    for k in k13_cases:
        call = _k13_call_args(tex_in, k)
        got, again = ncuda.launch_texbwd(*call), ncuda.launch_texbwd(*call)
        plain = ncuda.torch_impl.backward_textures(*call[1:])
        err = scaled_err(got, plain)
        checks[f'k13_{k}'] = {'twice_equal': torch.equal(got, again),
                              'plain_err_of_scale': err, 'plain_close': err <= N3MR_SUM_TOL}
        a, _ = k13_cases[k]
        times[f'k13_{k}'] = [device_ms(lambda: cuda_impl._run(k13_fn, 'n3mr_texbwd', a, dev),
                                       {'k': ('n3mr_texbwd_kernel',)})['k']
                             for _ in range(args.turns)]
    for k, (inp, rows, p) in red_cases.items():
        got, again = cuda_impl.launch_reduce(inp, rows, p), cuda_impl.launch_reduce(inp, rows, p)
        plain = cuda_impl.reduce_rows_plain(inp, rows, p)
        checks[f'reduce_{k}'] = {
            'twice_equal': all(torch.equal(x, y) for x, y in zip(got, again)),
            'plain_equal': all(torch.equal(x, y) for x, y in zip(got, plain))}
        a, keep = cuda_impl.reduce_args(inp, rows, p)
        times[f'reduce_{k}'] = [device_ms(lambda: cuda_impl._run(red_fn, 'softras_bwd_reduce', a,
                                                                 dev),
                                          {'k': ('softras_bwd_reduce_kernel',)})['k']
                                for _ in range(args.turns)]
    occ = {ts: ncuda.texbwd_occupancy(ts) for ts in (1, 2, 3, 4, 6)}
    census = {k: {'slot_rows': int(inp.lists.run_counts.sum()) + int(inp.lists.gcount.sum()),
                  'columns': rows.gslots.shape[2], 'views': inp.rows.shape[0],
                  'faces': inp.rows.shape[1], 'mt': inp.lists.gsrc.shape[2]}
              for k, (inp, rows, p) in red_cases.items()}
    failed = [f'{k}.{c}' for k, cs in checks.items() for c, v in cs.items()
              if isinstance(v, bool) and not v]
    print(json.dumps({'device': smi, 'checks': checks, 'failed': failed,
                      'k13_occupancy': occ, 'reduce_census': census, 'ms': times,
                      'median_ms': {k: float(np.median(v)) for k, v in times.items()}}),
          flush=True)
    if failed:
        print(f'time_texbwd_reduce: checks failed: {failed}', file=sys.stderr)
        return 1
    return 0


def _k13_call_args(tex_in, key):
    """launch_texbwd's arguments for a case '<input>_ts<ts>'."""
    name, ts = key.rsplit('_ts', 1)
    rows, fi, wt, dp, zc, g, eps = tex_in[name][0]
    ts = int(ts)
    return rows, (*rows.shape[:2], ts, ts, ts, 3), fi, wt, dp, zc, g, eps


if __name__ == '__main__':
    sys.exit(main())
