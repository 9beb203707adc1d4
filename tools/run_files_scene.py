#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 alone on one CUDA card: the files and
the scene at full width (``chip_smoke.files_and_scene``).

    python3 tools/run_files_scene.py

Builds the binned SoftRas kernels, then writes the 39,474-face sphere's
OBJ, MTL and PNGs from a seed into a temporary directory and drives demo
1's and demo 1.5's paths, the scene at 1024² and the voxels, with the
same checks as ``chip_smoke.py`` (its helpers rebuilt here: the pixel
sample, the hold against the plain version, the K1 launch count).
Prints phase 15's log lines and one JSON line of its numbers, beside the
card's name and power limit; exits 1 when a check fails.

Needs a card (exits 2 without one) and nvcc.
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
        print('run_files_scene: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import cuda_impl, torch_impl

    t0 = time.time()
    _build.build(['softras_fwd', 'softras_thr', 'softras_bwd'])
    C.log(f'build {time.time() - t0:.1f} s')
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    C.log(smi)
    gen = torch.Generator(device=dev)

    def sample_pixels(is_):
        gen.manual_seed(C.SEED + 1)
        idx = torch.randint(0, is_ * is_, (C.SAMPLES,), generator=gen, device=dev)
        return idx, torch_impl.pixel_centers(idx // is_, idx % is_, is_)

    def pixels_vs_plain(tag, fv, tex, p, image):
        idx, (xp, yp) = sample_pixels(p.image_size)
        col, _, _ = torch_impl.forward_pixels(fv, tex, p, xp, yp, chunk_pairs=1 << 24)
        got = image.reshape(image.shape[0], 4, -1)[:, :, idx].permute(0, 2, 1)
        f_rgb, e_rgb = C.beyond(got[..., :3], col[..., :3], C.TOL, pixel_dim=-1)
        f_a, e_a = C.beyond(got[..., 3], col[..., 3], C.TOL)
        C.check(f'{tag} rgb', f_rgb)
        C.check(f'{tag} alpha', f_a)
        C.log(f'  {tag}: {C.SAMPLES} pixels, rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), '
              f'alpha {f_a:.4f} (max {e_a:.3g})')
        return max(e_rgb, e_a)

    def zero_counts():
        cuda_impl.launch.launches = 0

    def read_counts():
        return {'softras_fwd': cuda_impl.launch.launches}

    t0 = time.time()
    out = C.files_and_scene(dict(dev=dev, smi=smi, zero_counts=zero_counts,
                                 read_counts=read_counts, sample_pixels=sample_pixels,
                                 pixels_vs_plain=pixels_vs_plain, no_dir=lambda tag: None,
                                 no_pxg=lambda tag: None))
    C.log(json.dumps({'phase15': out, 'seconds': time.time() - t0, 'card': smi}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
