#!/usr/bin/env python3
"""Drive the port's SoftRas mesh path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc``;
without a card it exits with code 2 and prints no result.  Phases, each
of which raises on failure:

  1. the device: name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source of the package (one nvcc each, in
     parallel) and print the compiler's register and spill report;
  3. every kernel against its plain PyTorch version on whole images:
     the forward at 128 and 256 px over the rasterizer's configurations;
     the top-K threshold over the same meshes, K = 1, 4, 16 and 40; the
     backward and its face reduction at 128 px over distance x rgb x
     alpha, texture sizes, vertex colours, batches, a ragged size,
     ``grad_mode='full'`` and big faces, each run twice for bit equality;
  4. the render path at full width: ``Renderer(image_size=1024)`` renders
     8 frames of the 39,474-face UV sphere with 5x5 texels per face,
     demo 1's camera; the launch count must equal the frames; 4,096
     random pixels of a frame are held against the plain version;
  5. the training step at full width (what ``bench.py`` times): 8 steps
     of ``soft_rasterize(...).sum().backward()`` and 8 through
     ``render_mesh`` with gradients to ``mesh.vertices`` and
     ``mesh.textures``, at 1024 px on the same sphere; one launch of each
     kernel per step; the gradient of 4,096 random pixels is held against
     the plain backward on those pixels; every kernel is timed alone and
     bounded from this run's pair counts;
  6. dense: 256 px on the same sphere, where the JAX package's per-tile
     cap of 2,048 faces binds; 4,096 pixels against the plain version;
  7. a trainer: 20 steps of demo 2's optimisation (120 views at 64 px of
     a 1,300-face sphere, hard rgb, silhouette IoU + Laplacian + flatten
     losses, Adam) towards silhouettes of an ellipsoid that the port
     renders itself; the loss must fall.  Before the steps, every kernel
     is held against its plain version on the rasterizer's inputs of the
     first step: whole images, all 120 views;
  8. one JSON line of the kernels; the last line is the device JSON.

The meshes, textures, cameras and pixel samples come from fixed seeds.

Tolerances.  Forward: atol 1e-4, at most 1% of pixels beyond (knife-edge
pixels, where a hard choice falls the other way and the pixel takes
another face's colour; the readings are at most 0.3%).  Threshold: 1e-6
relative, at most 0.1% of pixels beyond (readings: below 0.005%).
Backward: atol = 2e-3 * max|grad| and rtol = 2e-3, the JAX suite's own
(tests/test_softras_pallas.py:126-128): a gradient sums thousands of
pixels in another order than the plain version, of terms amplified by
1/sigma and 1/gamma.  At most 0.1% of its entries may lie beyond (a
knife-edge pair moves one face's entries; the readings are at most
0.01%), and none of the rows of the big faces, which a kernel of their
own computes.  In the backward checks the surface textures are equal on
the two sides of the texel selector's diagonal tie and the texture
gradients are folded over each tie pair
(jrender_tpu_torch/utils/checks.py), and each side computes the
threshold its own way (see tests/test_torch_kernels.py).  In the kernels
line, ``max_abs_err`` of the backward and of the reduction is a share of
max|grad|; ``plain_on`` says what the plain version's time covers: it
runs on a sample of the frame's pixels, the whole frame being a matter of
minutes.

Bounds.  ``softras_bwd``'s bound is that of the function the backward and
its reduction compute together: rows, lists and pixel maps read, one
gradient row per face written.  The slot rows between the two kernels
are the two-pass design's cost, not the function's; they appear only in
``softras_bwd_reduce``'s bound, as that kernel's input.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
FRAMES = 8
STEPS = 8
TRAIN_STEPS = 20
SAMPLES = 4096
# published peaks of one H100 SXM: fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of the main configuration (euclidean distance, softmax
# rgb, prod alpha, surface texels) per (pixel, face) pair, by how far the
# pair gets; counted from csrc/softras_pair.cuh and the kernels, an fma
# as two, exp and a division as one:
OPS_BBOX = 16    # every pair of a tile list: the inflated-bbox test
OPS_DIST = 65    # in the bbox: barycentrics, inside tests, one clamped edge
#                  projection and the squared distance
OPS_INSIDE = 56  # inside the face: the other two edge projections, the choice
OPS_SHADE = 60   # within the distance cut: sigmoid, clip, depth, alpha,
#                  count, softmax and texel
OPS_DEPTH = 25   # within the distance cut, threshold kernel: sigmoid, clip,
#                  depth, the list's compare
OPS_GRAD = 120   # within the threshold, backward: texel, softmax weight,
#                  colour chain, 9 vertex terms, 3 texel terms, their sums
TOL = 1e-4           # forward kernel vs plain
EDGE_FRAC = 0.01     # forward: share of knife-edge pixels allowed beyond
THR_RTOL = 1e-6
THR_FRAC = 0.001     # threshold: share of pixels allowed beyond
GRAD_FRAC = 0.001    # backward: share of entries allowed beyond atol =
#                      2e-3 * max|grad|, rtol = 2e-3 (checks.GRAD_TOL)


def log(*a):
    print(*a, flush=True)


def beyond(a, b, atol, pixel_dim=None):
    """Share of pixels of a beyond atol of b, and the max abs difference."""
    d = (a.double() - b.double()).abs()
    bad = d > atol
    if pixel_dim is not None:
        bad = bad.any(dim=pixel_dim)
    return bad.float().mean().item(), d.max().item()


def check(name, frac, limit=EDGE_FRAC):
    if not frac <= limit:
        raise AssertionError(f'{name}: {frac:.4f} beyond tolerance (limit {limit})')


def pair_census(face, p, lists, counts):
    """How far the (pixel, face) pairs of the kernels' walks get, counted
    from this frame's data: every pixel of a tile with every face of its
    list; those in the face's inflated bbox (enumerated face by face);
    those inside the face (closed barycentric test); the candidates within
    the distance cut (the forward kernel's own count map, which phase 3
    holds against the plain version); and the candidates within the top-K
    threshold, min(count, K) per pixel, which do backward work.  The
    ``over_`` counts are those of the tiles where some pixel has more than
    K candidates: the tiles the threshold kernel walks."""
    import torch
    from jrender_tpu_torch.ops.softras import binning, cuda_impl, torch_impl
    from jrender_tpu_torch.ops.softras import geometry as G
    is_, tile = p.image_size, cuda_impl.TILE
    tiles = -(-is_ // tile)
    face = face.reshape(-1, 9)
    r0, r1, c0, c1, empty = binning.pixel_ranges(face, is_, p.threshold)
    r0, c0 = r0.clamp(0, is_ - 1).long(), c0.clamp(0, is_ - 1).long()
    h = (r1.clamp(0, is_ - 1).long() - r0 + 1).clamp_min(0)
    w = (c1.clamp(0, is_ - 1).long() - c0 + 1).clamp_min(0)
    n = torch.where(empty, 0, h * w)
    fid = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    k = torch.arange(fid.numel(), device=n.device) - (n.cumsum(0) - n)[fid]
    rows, cols = r0[fid] + k // w[fid], c0[fid] + k % w[fid]
    xp, yp = torch_impl.pixel_centers(rows, cols, is_)
    inv, _, _ = G.face_info_preprocess(face)
    inside = G.check_pixel_inside(G.barycentric_coordinate(inv[fid], xp, yp))
    K = p.max_faces_id
    over_px = torch.nn.functional.pad(counts[0] > K, (0, tiles * tile - is_, 0, tiles * tile - is_))
    over = over_px.reshape(tiles, tile, tiles, tile).any(dim=3).any(dim=1)   # [ty, tx]
    pair_over = over[rows // tile, cols // tile]
    within = counts.clamp_max(K) if torch_impl.use_threshold(p, face.shape[0]) else counts
    return {'tile_list': int(lists.counts.sum().item()) * tile ** 2,
            'in_bbox': int(fid.numel()),
            'inside': int(inside.sum().item()),
            'candidates': int(counts.sum().item()),
            'within_thr': int(within.sum().item()),
            'over_tiles': int(over.sum().item()),
            'over_tile_list': int(lists.counts[0][over.reshape(-1)].sum().item()) * tile ** 2,
            'over_in_bbox': int(pair_over.sum().item()),
            'over_inside': int((inside & pair_over).sum().item()),
            'over_candidates': int(counts[0][over_px[:is_, :is_]].sum().item())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from jrender_tpu_torch import Mesh, Renderer, _build, deform
    from jrender_tpu_torch.ops.softras import (binning, cuda_impl, make_params,
                                               soft_rasterize, torch_impl)
    from jrender_tpu_torch.transform import look_at, perspective
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.utils.checks import fold_ties, grad_beyond, tie_symmetric
    from jrender_tpu_torch.utils.primitives import uv_sphere

    dev = torch.device('cuda')
    kernels_src = sorted(p.stem for p in (repo / 'jrender_tpu_torch' / 'csrc').glob('*.cu'))
    wrappers = {'softras_fwd': cuda_impl.launch, 'softras_thr': cuda_impl.launch_thr,
                'softras_bwd': cuda_impl.launch_bwd,
                'softras_bwd_reduce': cuda_impl.launch_reduce}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f'device: {kind} x{count}  torch {torch.__version__} cuda {torch.version.cuda}')
    log(smi)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    _build.build(kernels_src)
    log(f'build: {kernels_src} in {time.time() - t0:.1f} s')
    for name in kernels_src:
        # ptxas -v: per compiled function, its spills, then its registers
        # and static shared memory (the kernels' shared memory is dynamic)
        fn = spill = ''
        for line in _build.build_log(name).splitlines():
            if 'Compiling entry function' in line:
                fn = line.split("'")[1]
            elif 'spill stores' in line:
                spill = line.strip()
            elif 'Used' in line and 'registers' in line:
                log(f'  ptxas {fn}: {line.split(":", 1)[1].strip()}; {spill}')

    gen = torch.Generator(device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, reps=20, warm=2):
        """ms per call, CUDA events around ``reps`` calls after a warm-up."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    def textures(F, T, seed):
        gen.manual_seed(seed)
        return torch.rand((1, F, T, 3), generator=gen, device=dev)

    def sphere_faces(rings, segs, eye=(0.0, 0.0, -2.732)):
        v, f = uv_sphere(rings, segs)
        vt = perspective(look_at(torch.tensor(v, device=dev)[None], eye), angle=30)
        return face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9)

    def soup(F, B, T, seed, radius=(0.02, 0.25)):
        rng = np.random.RandomState(seed)
        c = rng.uniform(-0.8, 0.8, (B, F, 1, 2))
        r = rng.uniform(*radius, (B, F, 1, 1))
        ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
            + rng.uniform(-0.3, 0.3, (B, F, 3))
        xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
        z = 2.5 + rng.uniform(-0.4, 0.4, (B, F, 3, 1))
        fv = np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9)
        tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
        return torch.tensor(fv, device=dev), torch.tensor(tex, device=dev)

    def compare(tag, fv, tex, p):
        img, ag, cnt = cuda_impl.launch(cuda_impl.prepare(fv, tex, p), p)
        torch.cuda.synchronize()
        want, ag_w, cnt_w = torch_impl.soft_rasterize_fwd_plain(fv, tex, p, chunk_pairs=1 << 24)
        f_rgb, e_rgb = beyond(img[:, :3], want[:, :3], TOL, pixel_dim=1)
        f_a, e_a = beyond(img[:, 3], want[:, 3], TOL)
        f_c, _ = beyond(cnt.float(), cnt_w.float(), 0)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        check(f'{tag} count', f_c)
        if p.aggr_func_rgb == 'hard':
            f_id, _ = beyond(ag[:, 1], ag_w[:, 1], 0)
            check(f'{tag} face index', f_id)
        if not torch.isfinite(img).all():
            raise AssertionError(f'{tag}: non-finite output')
        log(f'  {tag}: rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), alpha {f_a:.4f} '
            f'(max {e_a:.3g}), count {f_c:.4f}')
        return max(e_rgb, e_a)

    def compare_thr(tag, fv, tex, p):
        """The threshold kernel against topk_threshold, whole image."""
        inputs = cuda_impl.prepare(fv, tex, p)
        _, _, cnt = cuda_impl.launch(inputs, p)
        thr = cuda_impl.launch_thr(inputs, cnt, p)
        torch.cuda.synchronize()
        want = torch_impl.topk_threshold_plain(fv, p, chunk_pairs=1 << 24)
        bad = (thr - want).abs() > THR_RTOL * want.abs()
        check(f'{tag} threshold', bad.float().mean().item(), THR_FRAC)
        K = p.max_faces_id
        if not (thr[cnt <= K] == p.far).all():
            raise AssertionError(f'{tag}: a pixel with at most K candidates has a threshold')
        log(f'  {tag}: K={K}, {(cnt > K).float().mean().item():.3f} of pixels over K, '
            f'{bad.float().mean().item():.6f} beyond (max {(thr - want).abs().max().item():.3g})')
        return (thr - want).abs().max().item()

    def compare_bwd(tag, fv, tex, p, mt=None):
        """The backward kernels and the reduction against their plain
        versions, whole image, on a seeded incoming gradient; run twice
        for bit equality.  Returns the max abs error over the scale."""
        surface = p.texture_type == 'surface'
        if surface:
            tex = tie_symmetric(tex)
        inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
        if mt is not None:
            # a smaller emit cap per face: what spans more tiles is a big face
            inputs = inputs._replace(lists=binning.build_tile_lists_compact(
                fv, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt,
                with_inverse=True))
        img, ag, cnt = cuda_impl.launch(inputs, p)
        thr = cuda_impl.topk_threshold(fv, p, inputs, cnt)
        gen.manual_seed(SEED + 3)
        g = torch.randn(img.shape, generator=gen, device=dev)
        rows = cuda_impl.launch_bwd(inputs, img, ag, thr, g, p)
        gf, gt = cuda_impl.launch_reduce(inputs, rows, p)
        gf2, gt2 = cuda_impl.soft_rasterize_bwd(fv, tex, img, ag, thr, g, p, inputs)
        torch.cuda.synchronize()
        if not (torch.equal(gf, gf2) and torch.equal(gt, gt2.reshape(gt.shape))):
            raise AssertionError(f'{tag}: two runs of the backward differ in their bits')
        # the reduction alone against its plain version, on the same rows
        rf, rt = cuda_impl.reduce_rows_plain(inputs, rows, p)
        (f_rf, e_rf), (f_rt, e_rt) = grad_beyond(gf, rf), grad_beyond(gt, rt)
        f_red, e_red = max(f_rf, f_rt), max(e_rf, e_rt)
        check(f'{tag} reduction', f_red, 0.0)
        # the whole backward against the plain one with its own threshold
        thr_plain = None if thr is None else torch_impl.topk_threshold_plain(
            fv, p, chunk_pairs=1 << 24)
        wf, wt = torch_impl.soft_rasterize_bwd_plain(fv, tex, img, ag, thr_plain, g, p,
                                                     chunk_pairs=1 << 22)
        wt = wt.reshape(gt.shape)
        if surface:
            gt, wt = fold_ties(gt), fold_ties(wt)
        (f_f, e_f), (f_t, e_t) = grad_beyond(gf, wf), grad_beyond(gt, wt)
        check(f'{tag} face gradient', f_f, GRAD_FRAC)
        check(f'{tag} texture gradient', f_t, GRAD_FRAC)
        # the big faces' rows come from a kernel of their own: none beyond
        is_big = inputs.lists.gpos >= 0
        check(f'{tag} face gradient of the big faces', grad_beyond(gf, wf, is_big)[0], 0.0)
        check(f'{tag} texture gradient of the big faces', grad_beyond(gt, wt, is_big)[0], 0.0)
        # the xy chain needs a soft distance and a soft alpha or rgb; the z
        # chain needs the softmax
        moves = p.aggr_func_rgb == 'softmax' or (p.dist_func != 'hard'
                                                  and p.aggr_func_alpha != 'hard')
        if moves and not gf.abs().max() > 0:
            raise AssertionError(f'{tag}: zero face gradient')
        big = int(inputs.lists.gcount.sum().item())
        log(f'  {tag}: face grad {f_f:.6f} beyond (max {e_f:.2g} of scale), texture grad '
            f'{f_t:.6f} (max {e_t:.2g}), reduction max {e_red:.2g}, big faces {big} '
            f'(none beyond), bit-equal twice')
        return max(e_f, e_t), e_red

    # ---- 3. kernels vs plain, whole images -------------------------------
    log('phase 3a: forward kernel vs plain, whole images')
    fv_mid = sphere_faces(38, 45)                          # 3,330 faces
    tex_mid = textures(fv_mid.shape[1], 25, SEED)
    configs = [(d, r, a) for d in ('hard', 'barycentric', 'euclidean')
               for r in ('hard', 'softmax') for a in ('hard', 'sum', 'prod')]
    for dist, rgb, alpha in configs:
        p = make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                        aggr_func_alpha=alpha)
        compare(f'sphere 128 {dist}/{rgb}/{alpha}', fv_mid, tex_mid, p)
    compare('sphere 256 default', fv_mid, tex_mid, make_params(image_size=256))
    for T in (1, 4, 25):
        fv, tex = soup(400, 1, T, SEED + T)
        compare(f'soup 256 T={T}', fv, tex, make_params(image_size=256))
    fv, tex = soup(400, 1, 3, SEED)
    compare('soup 256 vertex, background, fill_back off', fv, tex.reshape(1, 400, 3, 3),
            make_params(image_size=256, texture_type='vertex',
                        background_color=(0.2, 0.4, 0.6), fill_back=False))
    fv_b2, tex_b2 = soup(400, 2, 25, SEED + 7)
    compare('soup 256 B=2 sigma 1e-4', fv_b2, tex_b2, make_params(image_size=256, sigma_val=1e-4))
    compare('soup 200 ragged edge', fv_b2, tex_b2, make_params(image_size=200))

    log('phase 3b: threshold kernel vs plain, whole images')
    thr_err = 0.0
    for K in (1, 4, 16):
        for dist in ('hard', 'barycentric', 'euclidean'):
            p = make_params(image_size=128, dist_func=dist, sigma_val=1e-4,
                            max_faces_per_pixel_for_grad=K)
            thr_err = max(thr_err, compare_thr(f'sphere 128 {dist}', fv_mid, tex_mid, p))
    thr_err = max(thr_err, compare_thr('sphere 256', fv_mid, tex_mid, make_params(image_size=256)))
    # most pixels of this soup have fewer than 16 candidates: thr = far there
    thr_err = max(thr_err, compare_thr('soup 256 mostly under K', fv_b2, tex_b2,
                                       make_params(image_size=256, sigma_val=1e-4)))
    thr_err = max(thr_err, compare_thr('soup 200 ragged edge K=2', fv_b2, tex_b2,
                                       make_params(image_size=200, sigma_val=1e-4,
                                                   max_faces_per_pixel_for_grad=2)))
    # K = 40 is past the per-thread list: the kernel's bisection
    fv_dense, tex_dense = soup(600, 1, 1, SEED + 9, radius=(0.3, 0.6))
    thr_err = max(thr_err, compare_thr('dense soup 128, bisection', fv_dense, tex_dense,
                                       make_params(image_size=128, sigma_val=1e-4,
                                                   max_faces_per_pixel_for_grad=40)))

    log('phase 3c: backward kernels vs plain, whole images')
    bwd_err = red_err = 0.0

    def run_bwd(tag, fv, tex, p, mt=None):
        nonlocal bwd_err, red_err
        e, r = compare_bwd(tag, fv, tex, p, mt)
        bwd_err, red_err = max(bwd_err, e), max(red_err, r)

    for dist, rgb, alpha in configs:
        p = make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                        aggr_func_alpha=alpha, sigma_val=1e-4, gamma_val=1e-3)
        run_bwd(f'sphere 128 {dist}/{rgb}/{alpha}', fv_mid, tex_mid, p)
    run_bwd('sphere 128 renderer defaults', fv_mid, tex_mid, make_params(image_size=128))
    for T in (1, 4, 25):
        fv, tex = soup(400, 1, T, SEED + T)
        run_bwd(f'soup 128 T={T}', fv, tex,
                make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3))
    # fill_back off: the backward has no front-side check, so a back face
    # that the forward left out of the softmax maximum M still gets
    # exp((zpn - M) / gamma), which overflows float32 unless gamma > 0.012
    # (in the reference and the JAX package alike)
    fv, tex = soup(400, 1, 3, SEED)
    run_bwd('soup 128 vertex, fill_back off', fv, tex.reshape(1, 400, 3, 3),
            make_params(image_size=128, texture_type='vertex', fill_back=False,
                        sigma_val=1e-4, gamma_val=0.1))
    run_bwd('soup 128 B=2', fv_b2, tex_b2,
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3))
    run_bwd('soup 200 ragged edge', fv_b2, tex_b2,
            make_params(image_size=200, sigma_val=1e-4, gamma_val=1e-3))
    run_bwd("soup 128 grad_mode='full'", fv_b2, tex_b2,
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3, grad_mode='full'))
    run_bwd('soup 128 K=4', fv_b2, tex_b2,
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                        max_faces_per_pixel_for_grad=4))
    # an emit cap of 4 tiles sends most of this soup's faces to the big-face list
    run_bwd('soup 128 big faces', fv_b2, tex_b2,
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3), mt=4)
    run_bwd('dense soup 128 big faces, vertex', fv_dense,
            tex_dense.expand(-1, -1, 3, -1).contiguous(),
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                        texture_type='vertex'), mt=16)

    # ---- 4. the render path at full width ---------------------------------
    log('phase 4: Renderer(image_size=1024).render_mesh, 39,474 faces')
    v, f = uv_sphere(130, 153)
    gen.manual_seed(SEED)
    tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
    mesh = Mesh(v, f, textures=tex, texture_res=5, texture_type='surface')
    renderer = Renderer(image_size=1024)
    azimuths = [i * 360 // FRAMES for i in range(FRAMES)]

    zero_counts()
    frames = []
    with torch.no_grad():
        for az in azimuths:
            mesh.reset_()
            renderer.transform.set_eyes_from_angles(2.732, 30, az)
            frames.append(renderer.render_mesh(mesh, mode=None))
    torch.cuda.synchronize()
    render_counts = read_counts()
    if render_counts != {'softras_fwd': FRAMES, 'softras_thr': 0, 'softras_bwd': 0,
                         'softras_bwd_reduce': 0}:
        raise AssertionError(f'launches of {FRAMES} plain frames: {render_counts}')
    log(f'  launches on the render path: {render_counts} for {FRAMES} frames')
    for az, (alpha, rgb) in zip(azimuths, frames):
        if not (torch.isfinite(alpha).all() and torch.isfinite(rgb).all()):
            raise AssertionError(f'azimuth {az}: non-finite output')
        cov = alpha.gt(0.5).float().mean().item()
        if not cov > 0.05:
            raise AssertionError(f'azimuth {az}: alpha coverage {cov}')
    log(f'  frames finite; alpha coverage of frame 0: {frames[0][0].gt(0.5).float().mean().item():.4f}')

    # the rasterizer's inputs of frame 1, to hold its pixels against the plain version
    mesh.reset_()
    renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[1])
    with torch.no_grad():
        lit = renderer.transform(renderer.lighting(mesh, renderer.transform.eyes))
    fv_full = lit.face_vertices.reshape(1, -1, 9).contiguous()
    tex_full = lit.face_textures.contiguous()
    p_full = make_params(image_size=1024)

    def sample_pixels(is_):
        gen.manual_seed(SEED + 1)
        idx = torch.randint(0, is_ * is_, (SAMPLES,), generator=gen, device=dev)
        return idx, torch_impl.pixel_centers(idx // is_, idx % is_, is_)

    def pixels_vs_plain(tag, fv, tex, p, image):
        idx, (xp, yp) = sample_pixels(p.image_size)
        col, _, _ = torch_impl.forward_pixels(fv, tex, p, xp, yp, chunk_pairs=1 << 24)
        got = image.reshape(image.shape[0], 4, -1)[:, :, idx].permute(0, 2, 1)
        f_rgb, e_rgb = beyond(got[..., :3], col[..., :3], TOL, pixel_dim=-1)
        f_a, e_a = beyond(got[..., 3], col[..., 3], TOL)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        log(f'  {tag}: {SAMPLES} pixels, rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), '
            f'alpha {f_a:.4f} (max {e_a:.3g})')
        return max(e_rgb, e_a)

    alpha1, rgb1 = frames[1]
    image1 = torch.cat([rgb1, alpha1[:, None]], dim=1)
    fwd_err = pixels_vs_plain('frame 1 vs plain', fv_full, tex_full, p_full, image1)

    # timing: the kernel alone (CUDA events), render_mesh end to end (host
    # clock around work that ends in synchronize), and the plain version
    # on the sampled pixels only (the whole frame takes it a minute and a half)
    inputs = cuda_impl.prepare(fv_full, tex_full, p_full, for_grad=True)
    _, _, counts_full = cuda_impl.launch(inputs, p_full)
    fwd_ms = timed(lambda: cuda_impl.launch(inputs, p_full), reps=30)

    t0 = time.perf_counter()
    n_e2e = 2 * FRAMES
    with torch.no_grad():
        for i in range(n_e2e):
            mesh.reset_()
            renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i % FRAMES])
            renderer.render_mesh(mesh, mode='rgb')
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3 / n_e2e

    idx_u = torch.unique(sample_pixels(1024)[0])          # the sample without repeats
    xk, yk = torch_impl.pixel_centers(idx_u // 1024, idx_u % 1024, 1024)
    some = f'{idx_u.numel()} of {1024 * 1024} pixels'
    fwd_plain_ms = timed(lambda: torch_impl.forward_pixels(
        fv_full, tex_full, p_full, xk, yk, chunk_pairs=1 << 24), reps=2, warm=1)

    # ---- 5. the training step at full width --------------------------------
    log('phase 5: forward + backward at 1024 px, 39,474 faces, T = 25, K = 16')
    fv_leaf = fv_full.clone().requires_grad_(True)
    tex_leaf = tex_full.clone().requires_grad_(True)

    def bench_step():
        fv_leaf.grad = tex_leaf.grad = None
        image = soft_rasterize(fv_leaf, tex_leaf, image_size=1024, sigma_val=1e-5,
                               gamma_val=1e-4)
        image.sum().backward()

    def drive(tag, step):
        """STEPS steps from zeroed counts; every step must launch each
        kernel once.  Returns the counts of the run."""
        zero_counts()
        for i in range(STEPS):
            step(i)
            if read_counts() != {name: i + 1 for name in wrappers}:
                raise AssertionError(f'{tag}: launches after step {i + 1}: {read_counts()}')
        torch.cuda.synchronize()
        return read_counts()

    step_counts = drive('soft_rasterize', lambda i: bench_step())
    for name, g in (('face_vertices', fv_leaf.grad), ('textures', tex_leaf.grad)):
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise AssertionError(f'gradient of {name}: non-finite or zero')
    log(f'  soft_rasterize: launches {step_counts} for {STEPS} steps; '
        f'max |d face_vertices| {fv_leaf.grad.abs().max().item():.4g}, '
        f'max |d textures| {tex_leaf.grad.abs().max().item():.4g}')

    v_leaf = torch.tensor(v, device=dev).requires_grad_(True)
    t_leaf = tex.clone().requires_grad_(True)
    mesh_g = Mesh(v_leaf, f, textures=t_leaf, texture_res=5, texture_type='surface')

    def render_step(i=1):
        v_leaf.grad = t_leaf.grad = None
        mesh_g.reset_()
        renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i % FRAMES])
        alpha, rgb = renderer.render_mesh(mesh_g, mode=None)
        (alpha.sum() + rgb.sum()).backward()

    mesh_counts = drive('render_mesh', render_step)
    for name, g in (('mesh.vertices', v_leaf.grad), ('mesh.textures', t_leaf.grad)):
        if g is None or not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise AssertionError(f'gradient of {name}: missing, non-finite or zero')
    log(f'  render_mesh: launches {mesh_counts} for {STEPS} steps; '
        f'max |d vertices| {v_leaf.grad.abs().max().item():.4g}, '
        f'max |d textures| {t_leaf.grad.abs().max().item():.4g}')

    # the gradient of 4,096 pixels against the plain backward on those
    # pixels: the incoming gradient is zero elsewhere
    tex_sym = tie_symmetric(tex_full)
    in_sym = cuda_impl.prepare(fv_full, tex_sym, p_full, for_grad=True)
    img_s, ag_s, cnt_s = cuda_impl.launch(in_sym, p_full)
    thr_s = cuda_impl.launch_thr(in_sym, cnt_s, p_full)
    gen.manual_seed(SEED + 2)
    g_px = torch.randn((1, idx_u.numel(), 4), generator=gen, device=dev)
    g_img = torch.zeros((1, 4, 1024 * 1024), device=dev)
    g_img[:, :, idx_u] = g_px.permute(0, 2, 1)
    g_img = g_img.reshape(1, 4, 1024, 1024)
    gf_k, gt_k = cuda_impl.soft_rasterize_bwd(fv_full, tex_sym, img_s, ag_s, thr_s, g_img,
                                              p_full, in_sym)
    torch.cuda.synchronize()

    def at(x):
        return x.reshape(1, x.shape[1], -1)[:, :, idx_u].permute(0, 2, 1).contiguous()

    thr_px = torch_impl.topk_threshold(fv_full, p_full, xk, yk, chunk_pairs=1 << 24)
    f_thr = ((thr_px - at(thr_s[:, None])[..., 0]).abs() > THR_RTOL * thr_px.abs()).float().mean().item()
    check('1024 px threshold on the sampled pixels', f_thr, THR_FRAC)

    def plain_bwd_pixels():
        return torch_impl.backward_pixels(fv_full, tex_sym, at(img_s), at(ag_s), g_px,
                                          p_full, xk, yk, thr=thr_px, chunk_pairs=1 << 22)

    gf_w, gt_w = plain_bwd_pixels()
    f_f, e_f = grad_beyond(gf_k, gf_w)
    f_t, e_t = grad_beyond(fold_ties(gt_k), fold_ties(gt_w))
    check('1024 px face gradient of the sampled pixels', f_f, GRAD_FRAC)
    check('1024 px texture gradient of the sampled pixels', f_t, GRAD_FRAC)
    bwd_err = max(bwd_err, e_f, e_t)
    log(f'  gradient of {some} vs plain: face grad {f_f:.6f} beyond (max '
        f'{e_f:.2g} of scale), texture grad {f_t:.6f} (max {e_t:.2g}); threshold {f_thr:.6f}')

    # timings: each kernel alone, on the inputs of the bench step
    img_f, ag_f, _ = cuda_impl.launch(inputs, p_full)
    thr_f = cuda_impl.launch_thr(inputs, counts_full, p_full)
    g_ones = torch.ones_like(img_f)
    rows_f = cuda_impl.launch_bwd(inputs, img_f, ag_f, thr_f, g_ones, p_full)
    thr_ms = timed(lambda: cuda_impl.launch_thr(inputs, counts_full, p_full))
    bwd_ms = timed(lambda: cuda_impl.launch_bwd(inputs, img_f, ag_f, thr_f, g_ones, p_full))
    red_ms = timed(lambda: cuda_impl.launch_reduce(inputs, rows_f, p_full))
    red_plain_ms = timed(lambda: cuda_impl.reduce_rows_plain(inputs, rows_f, p_full), reps=5)
    thr_plain_ms = timed(lambda: torch_impl.topk_threshold(
        fv_full, p_full, xk, yk, chunk_pairs=1 << 24), reps=2, warm=1)
    bwd_plain_ms = timed(plain_bwd_pixels, reps=2, warm=1)
    # one PyTorch call that computes the reduction: index_add_ of the rows
    # by face id (rows of pairs the binning did not emit go to a dump row)
    cl = inputs.lists
    B, F, row = inputs.rows.shape
    L = cl.faces_sorted.shape[1]
    n_valid = cl.run_counts.sum(dim=1, keepdim=True)
    seg = torch.where(torch.arange(L, device=dev)[None] < n_valid, cl.faces_sorted, F).long()[0]
    dump = torch.zeros((F + 1, rows_f.gslots.shape[2]), device=dev)
    red_lib_ms = timed(lambda: dump.zero_().index_add_(0, seg, rows_f.gslots[0]), reps=5)

    step_ms = timed(bench_step, reps=STEPS)
    t0 = time.perf_counter()
    for i in range(STEPS):
        render_step(i)
    torch.cuda.synchronize()
    render_step_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    # the least time for the same work: operations or bytes, whichever
    # binds, for the pairs that this frame's data takes each far
    census = pair_census(fv_full, p_full, cl, counts_full)
    HW = p_full.image_size ** 2
    GC = rows_f.gslots.shape[2]
    pairs = int(cl.run_counts.sum().item())            # sorted (tile, face) pairs
    n_big = int(cl.gcount.sum().item())
    lists_bytes = 4 * (pairs + cl.starts.numel() + cl.run_counts.numel()
                       + n_big * 5 + cl.gcount.numel())

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes', \
            f'{ops:,} operations ({t_ops:.6f} ms), {nbytes:,} bytes ({t_bytes:.6f} ms)'

    # forward: each input read once (the rows, the valid part of the
    # lists), each output written once (image 4, aggrs 2, counts 1 per pixel)
    fwd_bound = bound(
        census['tile_list'] * OPS_BBOX + census['in_bbox'] * OPS_DIST
        + census['inside'] * OPS_INSIDE + census['candidates'] * OPS_SHADE,
        4 * inputs.rows.numel() + lists_bytes + 4 * B * (4 + 2 + 1) * HW)
    # threshold: the geometry part of the rows, the lists, the count map in
    # and the threshold map out; the pair math of the overfull tiles only
    thr_bound = bound(
        census['over_tile_list'] * OPS_BBOX + census['over_in_bbox'] * OPS_DIST
        + census['over_inside'] * OPS_INSIDE + census['over_candidates'] * OPS_DEPTH,
        4 * B * F * cuda_impl.ROW_BASE + lists_bytes + 4 * B * 2 * HW)
    # backward: the function that the backward and its reduction compute
    # together: rows, lists and 11 maps in, one gradient row per face out;
    # a warp walks only its face's bbox, so no pair pays the tile-list
    # test.  The slot rows between the two kernels are not counted here
    bwd_bound = bound(
        census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE
        + census['candidates'] * OPS_DEPTH + census['within_thr'] * OPS_GRAD
        + (pairs + n_big) * GC,
        4 * inputs.rows.numel() + lists_bytes + 4 * B * 11 * HW + 4 * B * F * GC)
    # reduction, as a kernel of its own: the written slot rows and the two
    # index maps in, the gradients out
    red_bound = bound(
        (pairs + n_big) * GC,
        4 * (pairs + n_big) * GC + 4 * (cl.gsrc.numel() + cl.gpos.numel()) + 4 * B * F * GC)
    busiest = int(cl.counts.max().item())
    covered = cl.counts.gt(0)
    log(f'  pairs: {census}; {int(cl.counts.sum().item()):,} tile-face pairs, '
        f'busiest tile {busiest}, mean over covered tiles '
        f'{cl.counts[covered].float().mean().item():.1f}; slot rows {pairs:,} of {L:,} '
        f'x {GC} floats, big faces {n_big}')
    for name, b in (('softras_fwd', fwd_bound), ('softras_thr', thr_bound),
                    ('softras_bwd', bwd_bound), ('softras_bwd_reduce', red_bound)):
        log(f'  bound {name}: {b[0]:.6f} ms by {b[1]}: {b[2]}')
    log(f'  kernels alone: forward {fwd_ms:.4f} ms, threshold {thr_ms:.4f} ms, backward '
        f'{bwd_ms:.4f} ms, reduction {red_ms:.4f} ms  [{smi}]')
    log(f'  plain versions on {some}: forward {fwd_plain_ms:.1f} ms, '
        f'threshold {thr_plain_ms:.1f} ms, backward {bwd_plain_ms:.1f} ms; reduction (all rows) '
        f'{red_plain_ms:.3f} ms, index_add_ {red_lib_ms:.3f} ms  [{smi}]')
    log(f'  render_mesh forward {render_ms:.3f} ms/frame; soft_rasterize fwd+bwd step '
        f'{step_ms:.3f} ms; render_mesh fwd+bwd step {render_step_ms:.3f} ms  [{smi}]')

    # ---- 6. dense: the JAX per-tile cap binds ---------------------------
    log('phase 6: 256 px, 39,474 faces')
    p_dense = make_params(image_size=256)
    dense_in = cuda_impl.prepare(fv_full, tex_full, p_dense)
    log(f'  busiest tile holds {int(dense_in.lists.counts.max().item())} faces '
        f'(the JAX pxt cap is 2048)')
    img_d, _, _ = cuda_impl.launch(dense_in, p_dense)
    torch.cuda.synchronize()
    pixels_vs_plain('dense 256 vs plain', fv_full, tex_full, p_dense, img_d)

    # ---- 7. a trainer: 20 steps of demo 2's optimisation -------------------
    log('phase 7: demo 2, 120 views at 64 px, 1,300 faces')
    VIEWS = 120
    v_s, f_s = uv_sphere(26, 26)
    v_s = v_s * np.float32(0.5 / 0.85)                     # radius 0.5
    rng = np.random.RandomState(SEED + 4)
    cams = (np.full(VIEWS, 2.732, np.float32),
            rng.uniform(-30, 60, VIEWS).astype(np.float32),
            rng.uniform(0, 360, VIEWS).astype(np.float32))
    trainer = Renderer(image_size=64, sigma_val=1e-4, aggr_func_rgb='hard',
                       camera_mode='look_at', viewing_angle=15)
    trainer.transform.set_eyes_from_angles(*(torch.tensor(c, device=dev) for c in cams))
    model = deform.DeformModel(v_s, f_s).to(dev)
    with torch.no_grad():
        ellipsoid = torch.tensor(v_s * np.float32([1.5, 0.6, 1.0]), device=dev)[None]
        targets = trainer.render_mesh(
            Mesh(ellipsoid.expand(VIEWS, -1, -1), model.faces.expand(VIEWS, -1, -1)),
            mode='silhouettes')
    # the rasterizer's inputs of the first step, all views: every kernel
    # against its plain version on whole images, at the tolerances of phase 3
    with torch.no_grad():
        v0 = model.vertices()
        lit = trainer.transform(trainer.lighting(
            Mesh(v0.expand(VIEWS, -1, -1), model.faces.expand(VIEWS, -1, -1)),
            trainer.transform.eyes))
    fv_t = lit.face_vertices.reshape(VIEWS, -1, 9).contiguous()
    tex_t = lit.face_textures.contiguous()
    r = trainer.rasterizer
    p_t = make_params(image_size=r.image_size, background_color=r.background_color,
                      near=r.near, far=r.far, fill_back=r.fill_back, eps=r.eps,
                      sigma_val=r.sigma_val, dist_func=r.dist_func, dist_eps=r.dist_eps,
                      gamma_val=r.gamma_val, aggr_func_rgb=r.aggr_func_rgb,
                      aggr_func_alpha=r.aggr_func_alpha, texture_type=r.texture_type,
                      max_faces_per_pixel_for_grad=r.max_faces_per_pixel_for_grad)
    tag = f'step 1, B={VIEWS}'
    fwd_err = max(fwd_err, compare(tag, fv_t, tex_t, p_t))
    thr_err = max(thr_err, compare_thr(tag, fv_t, tex_t, p_t))
    run_bwd(tag, fv_t, tex_t, p_t)

    optimizer = torch.optim.Adam(model.parameters(), lr=0.01, betas=(0.5, 0.99))
    zero_counts()
    losses = []
    t_train = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, sil = deform.deform_step(model, optimizer, trainer, targets)
        torch.cuda.synchronize()
        t_train.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    train_counts = read_counts()
    if train_counts != {name: TRAIN_STEPS for name in wrappers}:
        raise AssertionError(f'launches of {TRAIN_STEPS} training steps: {train_counts}')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f'the training loss did not fall: {losses}')
    if not (torch.isfinite(model.displace).all() and torch.isfinite(sil).all()):
        raise AssertionError('non-finite parameters or silhouettes after training')
    log(f'  launches {train_counts} for {TRAIN_STEPS} steps; loss {losses[0]:.6f} -> '
        f'{losses[-1]:.6f}; step {np.median(t_train[2:]):.3f} ms (median, host clock)  [{smi}]')

    # ---- 8. results -----------------------------------------------------
    def entry(name, source, replaces, err, ms, plain_ms, plain_on, b, library_ms=None):
        return {'name': name, 'route': 'cuda',
                'source': f'jrender_tpu_torch/csrc/{source}', 'replaces': replaces,
                'launches': step_counts[name], 'max_abs_err': err, 'ms': ms,
                'plain_ms': plain_ms, 'plain_on': plain_on, 'bound_ms': b[0],
                'bound_by': b[1], 'library_ms': library_ms}

    log(json.dumps({'kernels': [
        entry('softras_fwd', 'softras_fwd.cu', 'jrender_tpu/ops/softras/pxt_impl.py:370',
              fwd_err, fwd_ms, fwd_plain_ms, some, fwd_bound),
        entry('softras_thr', 'softras_thr.cu', 'jrender_tpu/ops/softras/pxt_impl.py:584',
              thr_err, thr_ms, thr_plain_ms, some, thr_bound),
        entry('softras_bwd', 'softras_bwd.cu', 'jrender_tpu/ops/softras/pxt_impl.py:856',
              bwd_err, bwd_ms, bwd_plain_ms, some, bwd_bound),
        entry('softras_bwd_reduce', 'softras_bwd.cu',
              'jrender_tpu/ops/softras/pxt_impl.py:1128', red_err, red_ms, red_plain_ms,
              'all rows', red_bound, red_lib_ms),
    ]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
