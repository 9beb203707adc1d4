#!/usr/bin/env python3
"""Find the pixels where the binned SoftRas backward kernel and its plain
version disagree, on one CUDA card.

    python3 tools/grad_knife_edges.py [--faces 200] [--texels 324] [--seed 13]
                                      [--grad-seed 3] [--size 128] [--sigma 1e-4]
                                      [--gamma 1e-3]

Makes ``chip_smoke.py``'s random soup (``--faces`` triangles, ``--texels``
texels a face, made equal on the two sides of the texel selector's
diagonal tie), runs the binned forward, threshold and backward kernels on
an incoming gradient drawn from ``--grad-seed`` (phase 3c's), and the plain
backward with its own threshold, in float32 and float64.  Prints one JSON
line: the share of face-gradient
entries beyond ``checks.grad_beyond``'s tolerance, the share of those the
float64 plain version does not explain (``checks.grad_unexplained``), the
faces beyond; and, for the face furthest off, each pixel whose
contribution differs (the kernel run on that pixel's incoming gradient
alone against ``torch_impl.backward_pixels``) with the pair's
barycentrics and distance terms.  A pixel where the float64 plain version
sides with the float32 one is a knife edge of the kernel's arithmetic.

Seeded; needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--faces', type=int, default=200)
    ap.add_argument('--texels', type=int, default=324)
    ap.add_argument('--seed', type=int, default=13)
    ap.add_argument('--grad-seed', type=int, default=3)
    ap.add_argument('--size', type=int, default=128)
    ap.add_argument('--sigma', type=float, default=1e-4)
    ap.add_argument('--gamma', type=float, default=1e-3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('grad_knife_edges: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from jrender_tpu_torch.ops.softras import cuda_impl, make_params, torch_impl
    from jrender_tpu_torch.ops.softras import geometry as G
    from jrender_tpu_torch.utils.checks import (GRAD_TOL, grad_beyond, grad_unexplained,
                                                tie_symmetric)

    dev = torch.device('cuda')
    rng = np.random.RandomState(args.seed)
    F, T, is_ = args.faces, args.texels, args.size
    # chip_smoke.py's soup(F, 1, T, seed)
    c = rng.uniform(-0.8, 0.8, (1, F, 1, 2))
    r = rng.uniform(0.02, 0.25, (1, F, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (1, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
        + rng.uniform(-0.3, 0.3, (1, F, 3))
    xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    z = 2.5 + rng.uniform(-0.4, 0.4, (1, F, 3, 1))
    fv = torch.tensor(np.concatenate([xy, z], -1).astype(np.float32).reshape(1, F, 9),
                      device=dev)
    tex = tie_symmetric(torch.tensor(rng.uniform(size=(1, F, T, 3)).astype(np.float32),
                                     device=dev))
    p = make_params(image_size=is_, sigma_val=args.sigma, gamma_val=args.gamma)
    inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
    img, ag, cnt = cuda_impl.launch(inputs, p)
    thr = cuda_impl.topk_threshold(fv, p, inputs, cnt)
    gen = torch.Generator(device=dev).manual_seed(args.grad_seed)
    g = torch.randn(img.shape, generator=gen, device=dev)
    gf, _ = cuda_impl.soft_rasterize_bwd(fv, tex, img, ag, thr, g, p, inputs)
    thr_p = torch_impl.topk_threshold_plain(fv, p)
    wf, _ = torch_impl.soft_rasterize_bwd_plain(fv, tex, img, ag, thr_p, g, p)
    x64, t64 = fv.double(), tex.double()
    i64, a64, _ = torch_impl.soft_rasterize_fwd_plain(x64, t64, p)
    ef, _ = torch_impl.soft_rasterize_bwd_plain(x64, t64, i64, a64,
                                                torch_impl.topk_threshold_plain(x64, p),
                                                g.double(), p)
    scale = wf.abs().max().item()
    d = (gf.double() - wf.double()).abs()
    bad = (d > GRAD_TOL * scale + GRAD_TOL * wf.double().abs())[0]
    faces = torch.nonzero(bad.any(-1)).reshape(-1).tolist()
    out = {'faces': F, 'texels': T, 'seed': args.seed, 'size': is_,
           'beyond': grad_beyond(gf, wf), 'unexplained': grad_unexplained(gf, wf, ef),
           'faces_beyond': faces, 'pixels': []}
    if faces:
        face = max(faces, key=lambda f: d[0, f].max().item())
        x, y = fv[0, face, 0::3], fv[0, face, 1::3]
        sq = G.border_inflation(p.threshold)
        cols = ((torch.stack([x.min() - sq, x.max() + sq]) * is_ + is_ - 1) / 2).tolist()
        rows = ((is_ - 1 - torch.stack([y.max() + sq, y.min() - sq]) * is_) / 2).tolist()
        face_rows = fv[0, face:face + 1]
        inv, sym, obt = G.face_info_preprocess(face_rows)
        for row in range(max(int(rows[0]) - 1, 0), min(int(rows[1]) + 2, is_)):
            for col in range(max(int(cols[0]) - 1, 0), min(int(cols[1]) + 2, is_)):
                one = torch.zeros_like(g)
                one[..., row, col] = g[..., row, col]
                kf, _ = cuda_impl.soft_rasterize_bwd(fv, tex, img, ag, thr, one, p, inputs)
                idx = torch.tensor([row * is_ + col], device=dev)
                xp, yp = torch_impl.pixel_centers(idx // is_, idx % is_, is_)

                def at(m):
                    return m.reshape(1, m.shape[1], -1)[:, :, idx].permute(0, 2, 1).contiguous()

                pf, _ = torch_impl.backward_pixels(fv, tex, at(img), at(ag), at(g), p, xp, yp,
                                                   thr=at(thr_p[:, None])[..., 0])
                qf, _ = torch_impl.backward_pixels(x64, t64, at(img).double(), at(ag).double(),
                                                   at(g).double(), p, xp.double(), yp.double(),
                                                   thr=at(thr_p[:, None])[..., 0].double())
                if (kf[0, face] - pf[0, face]).abs().max().item() <= GRAD_TOL * scale:
                    continue
                terms = torch_impl._pairwise_terms(face_rows, inv, sym, obt, xp, yp, p)
                out['pixels'].append({
                    'face': face, 'row': row, 'col': col,
                    'kernel': kf[0, face].tolist(), 'plain': pf[0, face].tolist(),
                    'plain64': qf[0, face].tolist(),
                    'terms': {k: v.reshape(-1).tolist() for k, v in terms.items()
                              if torch.is_tensor(v) and k in ('w', 'sign', 'dis_x', 'dis_y',
                                                              't', 'sf')}})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
