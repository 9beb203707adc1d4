#!/usr/bin/env python3
"""Drive the port's SoftRas (binned, dir, pxg, f_px and px_f routes) and N3MR
mesh paths on one CUDA card and check them.

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
  8. every N3MR kernel against its plain version on whole images of 64
     to 128 px: soups and a sphere, texture sizes 1, 2, 4 and 8, batches of 1
     and 2, ``fill_back``, a ragged size, a zero-area face, a NaN face and
     a face that spans most of the screen; the edge gradient with rgb,
     alpha and both; each backward run twice for bit equality;
  9. the N3MR path at full width: ``Renderer(dr_type='n3mr',
     image_size=1024).render_mesh`` renders 8 frames of the 39,474-face
     sphere with 2x2x2 texels per face (rgb, then silhouettes and depth);
     8 steps of ``rasterize(...).sum().backward()`` (what ``bench.py``'s
     ``n3mr_row`` times), one launch of each wrapper per step; the maps of
     4,096 random pixels, the whole texture gradient and the edge gradient
     of 48 faces are held against the plain versions; two steps with
     anti-aliasing (2048 px inside); every kernel is timed alone and
     bounded from this run's counts;
 10. a trainer: 20 Adam steps of demo 4's texture fit (256 px, texture
     size 4, orthographic camera at a random azimuth per step, ambient
     light only) on a 1,300-face sphere towards images the port renders
     from a seeded random texture; the loss must fall;
 10b. the fixed-order sums (ops/segment_sum.py): the vertex normals of the
     39,474-face sphere and their gradient, N3MR's depth gradient at 1024
     px: each run twice, bit-equal, and held against the CPU plain version;
 11. the dir route, which ``JR_DIR_MAX`` opens to small meshes (phases
     3-10 run with it unset and assert that the dir kernels never ran):
     a. both dir kernels against their plain versions and against the
        binned route on whole images of 32 to 256 px: distance x rgb x
        alpha, the renderer's defaults, texture sizes 1, 4 and 25, vertex
        colours with ``fill_back`` off, B = 2 with K = 1, 4 and 16, K = 40
        (the forward's bisection), ``grad_mode='full'`` at a size of tile
        8, faces over most of the screen, and a soup of exact depth ties
        whose Morton order is not the id order; count and threshold maps
        must equal the binned route's on 99.99% of pixels; each backward
        twice, bit-equal;
     b. bench.py's ``small`` row on the dir route: ``render_mesh`` at 1024
        px of the 288-face ``uv_sphere(13, 12)``, T = 25, K = 16, demo 1's
        camera: 8 frames, 8 steps of ``soft_rasterize(...).sum().backward()``
        and 8 through ``render_mesh``, one launch of each dir wrapper per
        step and none of the binned ones; 4,096 pixels and their gradient
        against the plain versions; each kernel timed alone and bounded
        from this run's pair counts; the steps and frames on both routes in
        turns; then all of it again on the 3,330-face ``uv_sphere(38, 45)``;
     c. demo 2's trainer (phase 7's configuration) on the dir route: the
        first step's gradient against phase 7's binned one, 20 steps, the
        loss must fall, the step time beside phase 7's;
 12. the pxg route, which ``JR_LAYOUT=pxg`` opens (phases 3-11 run with it
     unset and assert that no pxg kernel ran):
     a. the pxg kernels (partials, combine, threshold, backward, face sum)
        against their plain versions and against the binned route on whole
        images of 24 to 256 px, phase 11a's sweep, and once with work items
        of 8 faces, which split every tile of more; counts equal to the
        binned route's on every pixel, thresholds on 99.99%; each backward
        twice, bit-equal;
     b. bench.py's headline row on the pxg route: 8 ``render_mesh`` frames,
        8 steps of ``soft_rasterize(...).sum().backward()`` and 8 through
        ``render_mesh`` at 1024 px on the 39,474-face sphere, one launch of
        each pxg wrapper per step and none of the binned or dir ones (a step
        at K = 4 if no pixel has more than 16 candidates); the work items,
        the busiest tile's split and the overfull tiles; 4,096 pixels and
        their gradient against the plain versions; each kernel timed alone
        and bounded from this run's counts; the steps and frames on both
        routes in turns;
     c. demo 2's trainer on the pxg route: the first step's gradient against
        phase 7's binned one, 20 steps, the loss must fall;
 13. the f_px route, which ``JR_LAYOUT=f_px`` opens (phases 3-12 run with it
     unset and assert that no f_px or px_f kernel ran):
     a. its forward (K3), untruncated backward (K4) and face sum against
        their plain versions and the binned route on whole images of 32 to
        256 px, phase 11a's sweep, ``grad_mode='full'``; counts equal to the
        binned route's on every pixel; each backward twice, bit-equal; a
        binding K = 16 step takes the binned route;
     b. 8 ``render_mesh`` frames (one K3 launch each) and 8
        ``grad_mode='full'`` steps of ``soft_rasterize`` (one launch of K3,
        K4 and the face sum each) at 1024 px on the 39,474-face sphere, none
        of another route; 4,096 pixels and their gradient against the plain
        versions; each kernel timed alone and bounded;
 14. the px_f route (``JR_LAYOUT=px_f``):
     a. its forward with the threshold (K5), backward (K6) and face sum
        against their plain versions and the binned route at 24 to 256 px,
        the same sweep, K = 1, 4, 16 and 40 (bisection); counts on every
        pixel and thresholds on 99.99% equal to the binned route's; 256 px
        in 4 bands of tile rows: the bands side by side equal the whole
        image to the bit and their gradients summed the whole gradient;
     b. 8 frames, 8 steps of ``soft_rasterize`` and 8 of ``render_mesh`` at
        1024 px, K = 16, one launch of each px_f wrapper per step; 4,096
        pixels and their gradient against the plain versions; each kernel
        timed alone and bounded; the steps on both routes in turns;
 15. one JSON line of the kernels (18 of them); the last line is the device
     JSON.

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

N3MR tolerances (``jrender_tpu_torch/utils/checks.py``).  The z-buffer
kernel repeats the plain version's arithmetic operation by operation, so
the winners agree except where two faces' depths differ in the last bits:
at most 0.1% of the pixels may have another winner, and there the two
depths must agree to 1e-6 relative; elsewhere depth agrees to 1e-6
relative, weight and rgb to 1e-5, the winner's inverse and corner depths
exactly.  The texture and edge gradients sum the same float32 terms in
another order than the plain versions: atol 2e-5 * max|grad|, the JAX
suite's own (tests/test_n3mr.py:196-198, 338-340).  ``max_abs_err`` of
``n3mr_maps`` is that of depth, weight and rgb; of the two gradients a
share of max|grad|.

Dir tolerances are phase 3's; against the binned route the count and
threshold maps must agree to the bit on all but 0.01% of pixels, images
and gradients at phase 3's tolerances.  The dir kernels' bounds count the
function's work from the run's pairs (in a bbox, inside, candidates,
within the threshold), not the per-tile bbox tests of the whole face
table, which are the design's own cost; bytes: the table, bboxes and ids
read once, 8 floats per pixel written (forward), or the 11 floats of each
pixel with a candidate read and a gradient row per face written
(backward): a pixel with no candidate adds nothing to any gradient.

Pxg tolerances are phase 3's; against the binned route the count maps must
be equal on every pixel and the threshold maps to the bit on all but 0.01%.
The combine and the face sum are held to their plain versions on the
kernels' own inputs (the partial rows, the entry rows).  The pxg bounds
count the binned kernels' pair work and the bytes of each kernel's own
inputs and outputs (partial rows, depth lists, entry rows); the plain
partials run on the first 64 work items.

F_px and px_f tolerances are phase 3's, and the counts (and the
thresholds to the bit on 99.99% of pixels) equal the binned route's.
Against the plain version a gradient entry beyond the tolerance is not
counted where the plain version evaluated in float64 (its own forward and
threshold) shows the float32 plain version to be off there by at least a
quarter of the difference: a knife-edge pixel, which the renderer's
defaults at sizes that are not powers of two have most of
(``checks.grad_unexplained``); the other entries are held to the 0.1%,
and every entry to the binned kernels' gradient at the same 0.1%.  The
bounds count the binned kernels' pair work (the lists of 16 x 16 tiles),
as the pxg forward's does: the wider tiles' extra bbox tests are the
tiling's cost, not the function's.

Bounds.  ``softras_bwd``'s bound is that of the function the backward and
its reduction compute together: rows, lists and the maps of the pixels
with a candidate read, one gradient row per face written.  The slot rows between the two kernels
are the two-pass design's cost, not the function's; they appear only in
``softras_bwd_reduce``'s bound, as that kernel's input.  The N3MR
bounds count, from this run's maps: the (pixel, face) pairs of the tile
lists and those that pass the inside test (``n3mr_maps``), the pixels a
face won (``n3mr_texbwd``: face_index of every pixel, the other maps of
the won pixels only; the per-face rows are the bbox walk's input, not the
function's) and the cells of the edge scans (``n3mr_edgebwd``,
``torch_impl.edge_scan_census``: the difference on every scanned cell, the
distances only where it is positive); each input is read once and each
output written once.
"""
from __future__ import annotations

import json
import os
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
OPS_LIST = 2     # a candidate, dir forward with the threshold: the list's compare
OPS_GRAD = 120   # within the threshold, backward: texel, softmax weight,
#                  colour chain, 9 vertex terms, 3 texel terms, their sums
OPS_COMBINE = 14  # pxg combine, per (work item, pixel): alpha, count, the
#                  softmax maximum, the scale's exponential and four sums
TOL = 1e-4           # forward kernel vs plain
EDGE_FRAC = 0.01     # forward: share of knife-edge pixels allowed beyond
THR_RTOL = 1e-6
THR_FRAC = 0.001     # threshold: share of pixels allowed beyond
GRAD_FRAC = 0.001    # backward: share of entries allowed beyond atol =
#                      2e-3 * max|grad|, rtol = 2e-3 (checks.GRAD_TOL)
# fp32 operations of the N3MR kernels, counted from csrc/n3mr_*.cu the same way:
N_OPS_EDGE = 19      # a front face of a tile list against a pixel: the inside test
N_OPS_DEPTH = 32     # inside: barycentrics, clip, normalisation, depth, compare
N_OPS_SAMPLE = 12    # a drawn pixel: texture coordinates and tent weights ...
N_OPS_TAP = 2        # ... and a multiply-add per live tap and channel (8 x 3 taps)
N_OPS_TEXROW = 4     # texture gradient: per won pixel and output element
N_OPS_CHANNEL = 2    # edge gradient, a scanned cell: per channel the difference
#                      times the gradient ...
N_OPS_CELL = 14      # ... and where their sum is positive: base and the two distances
N_EDGE_FACES = 48    # faces whose edge gradient is held against the plane sweep
N_TRAIN_STEPS = 20


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
    threshold, min(count, K) per pixel, which do backward work; and the
    pixels with a candidate (``drawn``), the only ones whose maps a backward
    needs.  The ``over_`` counts are those of the tiles where some pixel has more than
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
            'drawn': int((counts > 0).sum().item()),
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
    from jrender_tpu_torch.ops import segment_sum
    from jrender_tpu_torch.ops.softras import (binning, cuda_impl, dir_impl, fpx_impl,
                                               make_params, pxf_impl, pxg_impl, route,
                                               soft_rasterize, tiled, torch_impl)
    from jrender_tpu_torch.transform import look_at, perspective
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.structures import vertex_normals_fn
    from jrender_tpu_torch.utils.checks import (fold_ties, grad_beyond, grad_unexplained,
                                                tie_soup, tie_symmetric)
    from jrender_tpu_torch.utils.primitives import uv_sphere

    dev = torch.device('cuda')
    kernels_src = sorted(p.stem for p in (repo / 'jrender_tpu_torch' / 'csrc').glob('*.cu'))
    wrappers = {'softras_fwd': cuda_impl.launch, 'softras_thr': cuda_impl.launch_thr,
                'softras_bwd': cuda_impl.launch_bwd,
                'softras_bwd_reduce': cuda_impl.launch_reduce}

    dir_wrappers = {'softras_dir_fwd': dir_impl.launch_dir_fwd,
                    'softras_dir_bwd': dir_impl.launch_dir_bwd}
    pxg_wrappers = {'softras_pxg_fwd': pxg_impl.launch_pxg_fwd,
                    'softras_pxg_combine': pxg_impl.launch_pxg_combine,
                    'softras_pxg_thr': pxg_impl.launch_pxg_thr,
                    'softras_pxg_bwd': pxg_impl.launch_pxg_bwd}
    tiled_wrappers = {'softras_fpx_fwd': fpx_impl.launch_fpx_fwd,
                      'softras_fpx_bwd': fpx_impl.launch_fpx_bwd,
                      'softras_pxf_fwd': pxf_impl.launch_pxf_fwd,
                      'softras_pxf_bwd': pxf_impl.launch_pxf_bwd}
    # the face sum after the pxg, f_px and px_f backward kernels, which vertex
    # normals and N3MR's depth gradient share, counts in
    # segment_sum.launch_segment_sum (``read_sum``)
    # phases 3-10 take the binned route: JR_DIR_MAX is unset until phase 11,
    # JR_LAYOUT until phase 12
    os.environ.pop('JR_DIR_MAX', None)
    os.environ.pop('JR_LAYOUT', None)

    def zero_counts():
        for w in (*wrappers.values(), *dir_wrappers.values(), *pxg_wrappers.values(),
                  *tiled_wrappers.values(), segment_sum.launch_segment_sum):
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    def read_dir():
        return {name: w.launches for name, w in dir_wrappers.items()}

    def no_dir(tag):
        if any(read_dir().values()):
            raise AssertionError(f'{tag}: the dir kernels ran on the binned route: {read_dir()}')

    def read_pxg():
        return {name: w.launches for name, w in pxg_wrappers.items()}

    def read_tiled():
        return {name: w.launches for name, w in tiled_wrappers.items()}

    def read_sum():
        return segment_sum.launch_segment_sum.launches

    def no_pxg(tag):
        if any(read_pxg().values()) or any(read_tiled().values()):
            raise AssertionError(f'{tag}: the pxg, f_px or px_f kernels ran with JR_LAYOUT '
                                 f'unset: {read_pxg()}, {read_tiled()}')

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
    no_dir('phase 4')
    no_pxg('phase 4')
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
    no_dir('phase 5')
    no_pxg('phase 5')
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
    no_dir('phase 5')
    no_pxg('phase 5')
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
    # together: rows, lists and the 11 maps of the pixels with a candidate
    # in, one gradient row per face out; a warp walks only its face's bbox,
    # so no pair pays the tile-list test.  The slot rows between the two
    # kernels are not counted here
    bwd_bound = bound(
        census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE
        + census['candidates'] * OPS_DEPTH + census['within_thr'] * OPS_GRAD
        + (pairs + n_big) * GC,
        4 * inputs.rows.numel() + lists_bytes + 4 * 11 * census['drawn'] + 4 * B * F * GC)
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

    def first_grad(m):
        """The gradient of the loss at the model's parameters (no step)."""
        m.zero_grad(set_to_none=True)
        m.loss(trainer, targets)[0].backward()
        g = torch.cat([m.displace.grad.reshape(-1), m.center.grad.reshape(-1)])
        m.zero_grad(set_to_none=True)
        return g

    grad_binned = first_grad(model)                      # held against phase 11c
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
    no_dir('phase 7')
    no_pxg('phase 7')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f'the training loss did not fall: {losses}')
    if not (torch.isfinite(model.displace).all() and torch.isfinite(sil).all()):
        raise AssertionError('non-finite parameters or silhouettes after training')
    log(f'  launches {train_counts} for {TRAIN_STEPS} steps; loss {losses[0]:.6f} -> '
        f'{losses[-1]:.6f}; step {np.median(t_train[2:]):.3f} ms (median, host clock)  [{smi}]')

    # ---- 8. N3MR kernels vs plain, whole images ----------------------------
    log('phase 8: N3MR kernels vs plain, whole images')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain, rasterize
    from jrender_tpu_torch.ops.n3mr.api import fill_back_faces, fill_back_textures
    from jrender_tpu_torch.utils.checks import (N3MR_SUM_TOL, n3mr_maps_beyond,
                                                n3mr_special_faces, scaled_err)
    n_wrappers = {'n3mr_maps': ncuda.launch_maps, 'n3mr_texbwd': ncuda.launch_texbwd,
                  'n3mr_edgebwd': ncuda.launch_edgebwd}
    n_err = dict.fromkeys(n_wrappers, 0.0)

    def n_zero_counts():
        for w in n_wrappers.values():
            w.launches = 0

    def n_read_counts():
        return {name: w.launches for name, w in n_wrappers.items()}

    def n3mr_texture(B, F, ts, seed):
        gen.manual_seed(seed)
        return torch.rand((B, F, ts, ts, ts, 3), generator=gen, device=dev)

    def n3mr_plain_maps(face, tex, is_, eps, **kw):
        maps = list(nplain.forward_maps(face, is_, 0.1, 100.0, **kw))
        return maps + [nplain.trilinear_rgb_from_maps(tex, *maps[:3], maps[4], eps)]

    def twice(tag, fn):
        """fn() run twice; raises unless the two results have the same bits."""
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f'{tag}: two runs differ in their bits')
        return a

    def n3mr_compare(tag, face, tex, is_, eps=1e-3):
        """The three kernels against their plain versions on whole images:
        the z-buffer's maps and rgb, then both gradients on the kernel's
        maps and seeded incoming gradients, each run twice."""
        rows, *got = ncuda.forward_maps(face, tex, is_, 0.1, 100.0, eps)
        torch.cuda.synchronize()
        share, e_maps = n3mr_maps_beyond(got, n3mr_plain_maps(face, tex, is_, eps))
        fi, wt, dp, finv, zc, rgb = got
        alpha = (fi >= 0).float()
        gen.manual_seed(SEED + 5)
        gr = torch.randn(rgb.shape, generator=gen, device=dev)
        ga = torch.randn(alpha.shape, generator=gen, device=dev)
        g_tex = twice(f'{tag} texture gradient', lambda: ncuda.backward_textures(
            rows, tex.shape, fi, wt, dp, zc, gr, eps))
        e_tex = scaled_err(g_tex, nplain.backward_textures(tex.shape, fi, wt, dp, zc, gr, eps))
        check(f'{tag} texture gradient', e_tex, N3MR_SUM_TOL)
        e_edge = 0.0
        for rr, ra in ((True, True), (True, False), (False, True)):
            args = (face, fi, rgb, alpha, gr, ga, is_, eps, rr, ra)
            g_face = twice(f'{tag} edge gradient', lambda: ncuda.backward_pixel_map(*args))
            e = scaled_err(g_face, nplain.backward_pixel_map(*args))
            check(f'{tag} edge gradient rgb={rr} alpha={ra}', e, N3MR_SUM_TOL)
            if not (g_face.abs().max() > 0 and (g_face[..., 2::3] == 0).all()):
                raise AssertionError(f'{tag}: edge gradient zero, or not zero in z')
            e_edge = max(e_edge, e)
        for name, e in (('n3mr_maps', e_maps), ('n3mr_texbwd', e_tex), ('n3mr_edgebwd', e_edge)):
            n_err[name] = max(n_err[name], e)
        log(f'  {tag}: {share:.6f} of pixels with another winner, maps max {e_maps:.2g}; '
            f'texture grad {e_tex:.2g} of scale, edge grad {e_edge:.2g}; '
            f'covered {alpha.mean().item():.3f}; bit-equal twice')

    for ts in (1, 2, 4):
        fv, _ = soup(300, 1, 1, SEED + 10 + ts)
        n3mr_compare(f'soup 128 ts={ts}', fv, n3mr_texture(1, 300, ts, SEED + ts), 128)
    fv_n2, _ = soup(300, 2, 1, SEED + 20)
    n3mr_compare('soup 64 B=2', fv_n2, n3mr_texture(2, 300, 2, SEED + 21), 64)
    n3mr_compare('soup 72 ragged edge, eps 1e-4', fv_n2, n3mr_texture(2, 300, 2, SEED + 21),
                 72, eps=1e-4)
    n3mr_compare('sphere 128 fill_back',
                 fill_back_faces(fv_mid.reshape(1, -1, 3, 3)).reshape(1, -1, 9),
                 fill_back_textures(n3mr_texture(1, fv_mid.shape[1], 2, SEED + 22)).contiguous(),
                 128)
    # a texture size that the texture gradient sums in several walks
    n3mr_compare('soup 64 ts=8', fv_n2, n3mr_texture(2, 300, 8, SEED + 24), 64)
    # a face over most of the screen (a big face of the binning), a
    # zero-area face and a NaN face; the last two must win no pixel
    fv_sp = n3mr_special_faces(fv_n2)
    n3mr_compare('soup 128 big, zero-area and NaN faces', fv_sp,
                 n3mr_texture(2, 300, 4, SEED + 23), 128)
    # with an emit cap of 4 tiles most faces go through the big-face list:
    # the same maps, bit for bit
    rows_sp, *maps_sp = ncuda.forward_maps(fv_sp, None, 128, 0.1, 100.0, 1e-3)
    lists_sp = binning.build_tile_lists_compact(
        fv_sp * fv_sp.new_tensor([1.0, -1.0, 1.0] * 3), 128, ncuda.TILE, ncuda.TILE, 0.0, 4)
    maps_big = ncuda.launch_maps(rows_sp, lists_sp, None, 128, 0.1, 100.0, 1e-3)
    fi_sp = maps_sp[0]
    if not (int(lists_sp.gcount.min()) >= 10
            and all(torch.equal(a, b) for a, b in zip(maps_sp[:5], maps_big[:5]))):
        raise AssertionError('the maps through the big-face list differ')
    if not ((fi_sp == 0).any() and not ((fi_sp == 1) | (fi_sp == 2)).any()):
        raise AssertionError('special faces: the big face is missing or a degenerate face won')
    log(f'  big-face list of {int(lists_sp.gcount.min())} faces: the same maps; the '
        f'zero-area and NaN faces win no pixel')

    # ---- 9. the N3MR path at full width -------------------------------------
    log('phase 9: N3MR at 1024 px, 39,474 faces, 2x2x2 texels per face')
    F_n = f.shape[0]
    tex_n = n3mr_texture(1, F_n, 2, SEED + 6)
    mesh_n = Mesh(v, f, textures=tex_n, texture_res=2, dr_type='n3mr')
    renderer_n = Renderer(dr_type='n3mr', image_size=1024)
    modes = ['rgb'] * (FRAMES - 2) + ['silhouettes', 'depth']

    def n3mr_frame(i, mode):
        mesh_n.reset_()
        renderer_n.transform.set_eyes_from_angles(2.732, 0, azimuths[i % FRAMES])
        return renderer_n.render_mesh(mesh_n, mode=mode)

    n_zero_counts()
    with torch.no_grad():
        n_frames = [n3mr_frame(i, mode) for i, mode in enumerate(modes)]
    torch.cuda.synchronize()
    n_render_counts = n_read_counts()
    if n_render_counts != {'n3mr_maps': FRAMES, 'n3mr_texbwd': 0, 'n3mr_edgebwd': 0}:
        raise AssertionError(f'N3MR launches of {FRAMES} plain frames: {n_render_counts}')
    for mode, img in zip(modes, n_frames):
        want_shape = (1, 3, 1024, 1024) if mode == 'rgb' else (1, 1024, 1024)
        if tuple(img.shape) != want_shape or not torch.isfinite(img).all():
            raise AssertionError(f'N3MR {mode} frame: shape {tuple(img.shape)} or non-finite')
    cov_n = n_frames[-2].mean().item()
    if not (cov_n > 0.05 and n_frames[0].amax(dim=1).gt(0).float().mean().item() > 0.05
            and n_frames[-1].min().item() < 10.0):
        raise AssertionError(f'N3MR frames: the sphere is not in view (coverage {cov_n})')
    log(f'  launches on the render path: {n_render_counts} for {FRAMES} frames '
        f'({modes.count("rgb")} rgb, silhouettes, depth); silhouette coverage {cov_n:.4f}')
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(2 * FRAMES):
            n3mr_frame(i, 'rgb')
    torch.cuda.synchronize()
    n_render_ms = (time.perf_counter() - t0) * 1e3 / (2 * FRAMES)

    # the step bench.py's n3mr_row times: the gradient of sum(rgb) with
    # respect to the face vertices and the textures
    fv_n = sphere_faces(130, 153)
    fv_leaf_n = fv_n.reshape(1, -1, 3, 3).clone().requires_grad_(True)
    tex_leaf_n = tex_n.clone().requires_grad_(True)

    def n3mr_step(aa=False):
        fv_leaf_n.grad = tex_leaf_n.grad = None
        rasterize(fv_leaf_n, tex_leaf_n, image_size=1024, anti_aliasing=aa).sum().backward()

    def n3mr_grads_ok(tag):
        for name, g in (('faces', fv_leaf_n.grad), ('textures', tex_leaf_n.grad)):
            if g is None or not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'{tag}: gradient of {name} missing, non-finite or zero')

    n_zero_counts()
    for i in range(STEPS):
        n3mr_step()
        if n_read_counts() != dict.fromkeys(n_wrappers, i + 1):
            raise AssertionError(f'N3MR launches after step {i + 1}: {n_read_counts()}')
    torch.cuda.synchronize()
    n_step_counts = n_read_counts()
    n3mr_grads_ok('rasterize step')
    log(f'  rasterize: launches {n_step_counts} for {STEPS} steps; '
        f'max |d faces| {fv_leaf_n.grad.abs().max().item():.4g}, '
        f'max |d textures| {tex_leaf_n.grad.abs().max().item():.4g}')
    n_step_ms = timed(n3mr_step, reps=STEPS)
    t0 = time.perf_counter()
    for _ in range(2):
        n3mr_step(aa=True)
    torch.cuda.synchronize()
    n_aa_ms = (time.perf_counter() - t0) * 1e3 / 2
    n3mr_grads_ok('anti-aliased step')

    # the kernels on the step's inputs, against the plain versions: the maps
    # of 4,096 pixels, the whole texture gradient, the edge gradient of a
    # sample of the faces that won a pixel
    EPS_N = 1e-4                                           # rasterize's default
    rows_n = nplain.face_rows(fv_n, 1024)
    lists_n = ncuda.tile_lists(fv_n, 1024)
    maps_n = ncuda.launch_maps(rows_n, lists_n, tex_n, 1024, 0.1, 100.0, EPS_N)
    fi_n, wt_n, dp_n, finv_n, zc_n, rgb_n = maps_n
    idx_n = sample_pixels(1024)[0]

    def plain_maps_sample():
        return n3mr_plain_maps(fv_n, tex_n, 1024, EPS_N, face_chunk=1024, pixels=idx_n)

    share_n, e_maps = n3mr_maps_beyond(
        [m.reshape(1, 1024 * 1024, *m.shape[3:])[:, idx_n] for m in maps_n],
        plain_maps_sample())
    n_err['n3mr_maps'] = max(n_err['n3mr_maps'], e_maps)
    gen.manual_seed(SEED + 7)
    gr_n = torch.randn(rgb_n.shape, generator=gen, device=dev)

    def plain_texbwd():
        return nplain.backward_textures(tex_n.shape, fi_n, wt_n, dp_n, zc_n, gr_n, EPS_N)

    g_tex_n = twice('1024 px texture gradient', lambda: ncuda.launch_texbwd(
        rows_n, tex_n.shape, fi_n, wt_n, dp_n, zc_n, gr_n, EPS_N))
    e_tex = scaled_err(g_tex_n, plain_texbwd())
    check('1024 px texture gradient', e_tex, N3MR_SUM_TOL)
    n_err['n3mr_texbwd'] = max(n_err['n3mr_texbwd'], e_tex)
    alpha_n = (fi_n >= 0).float()
    edge_in = ncuda.edge_inputs(fv_n, fi_n, rgb_n, alpha_n, gr_n, alpha_n, 1024, True, False)
    g_face_n = twice('1024 px edge gradient', lambda: ncuda.launch_edgebwd(
        *edge_in, EPS_N, True, False))
    won = torch.unique(fi_n[fi_n >= 0])
    gen.manual_seed(SEED + 8)
    ids_n = won[torch.randperm(won.numel(), generator=gen, device=dev)[:N_EDGE_FACES]].long()

    def plain_edge_sample():
        return nplain.backward_pixel_map(fv_n, fi_n, rgb_n, alpha_n, gr_n, alpha_n, 1024,
                                         EPS_N, True, False, faces=ids_n)

    e_edge = scaled_err(g_face_n[:, ids_n], plain_edge_sample())
    check('1024 px edge gradient of the sampled faces', e_edge, N3MR_SUM_TOL)
    n_err['n3mr_edgebwd'] = max(n_err['n3mr_edgebwd'], e_edge)
    log(f'  vs plain: maps of {SAMPLES} pixels {share_n:.6f} with another winner (max '
        f'{e_maps:.2g}); texture grad, whole frame, {e_tex:.2g} of scale; edge grad of '
        f'{ids_n.numel()} of {won.numel()} drawn faces {e_edge:.2g} of scale')

    # timings: each kernel alone on the step's inputs, its plain version, and
    # for the texture gradient the one PyTorch call that sums the same rows
    maps_ms = timed(lambda: ncuda.launch_maps(rows_n, lists_n, tex_n, 1024, 0.1, 100.0, EPS_N))
    texbwd_ms = timed(lambda: ncuda.launch_texbwd(rows_n, tex_n.shape, fi_n, wt_n, dp_n, zc_n,
                                                  gr_n, EPS_N))
    edgebwd_ms = timed(lambda: ncuda.launch_edgebwd(*edge_in, EPS_N, True, False))
    edge_prep_ms = timed(lambda: ncuda.edge_inputs(fv_n, fi_n, rgb_n, alpha_n, gr_n, alpha_n,
                                                   1024, True, False))
    n_bin_ms = timed(lambda: ncuda.tile_lists(fv_n, 1024), reps=5)
    maps_plain_ms = timed(plain_maps_sample, reps=2, warm=1)
    texbwd_plain_ms = timed(plain_texbwd, reps=5, warm=1)
    edge_plain_ms = timed(plain_edge_sample, reps=2, warm=1)
    tex_rows = nplain.texture_grad_rows(fi_n, wt_n, dp_n, zc_n, gr_n, 2, EPS_N)
    seg_n = torch.where(fi_n >= 0, fi_n, F_n).reshape(-1).long()
    dump_n = torch.zeros((F_n + 1, tex_rows.shape[1]), device=dev)
    texbwd_lib_ms = timed(lambda: dump_n.zero_().index_add_(0, seg_n, tex_rows), reps=5)

    # bounds, from this run's counts
    HW_n = 1024 * 1024
    T3_n = tex_n[0, 0].numel()
    front_n = rows_n[0, :, nplain.ROW_FRONT] > 0.5
    tile_n = ncuda.TILE
    ids_run = lists_n.faces_sorted[0, :int(lists_n.run_counts.sum().item())].long()
    front_pairs = int(front_n[ids_run].sum().item()) * tile_n ** 2     # no big face here
    n_big_n = int(lists_n.gcount.sum().item())
    # (pixel, face) pairs that pass the inside test: each front face's pixel
    # bbox enumerated and tested with the plain version's own predicate
    neg_y = fv_n.reshape(-1, 9) * fv_n.new_tensor([1.0, -1.0, 1.0] * 3)
    r0, r1, c0, c1, empty = binning.pixel_ranges(neg_y, 1024, 0.0)
    r0, c0 = r0.clamp(0, 1023).long(), c0.clamp(0, 1023).long()
    h_b = (r1.clamp(0, 1023).long() - r0 + 1).clamp_min(0)
    w_b = (c1.clamp(0, 1023).long() - c0 + 1).clamp_min(0)
    n_b = torch.where(empty | ~front_n, 0, h_b * w_b)
    fid_b = torch.repeat_interleave(torch.arange(F_n, device=dev), n_b)
    k_b = torch.arange(fid_b.numel(), device=dev) - (n_b.cumsum(0) - n_b)[fid_b]
    px_b = (r0[fid_b] + k_b // w_b[fid_b]) * 1024 + c0[fid_b] + k_b % w_b[fid_b]
    inside_pairs = int(nplain._pair_terms(rows_n[0, fid_b], *nplain._pixel_coords(
        px_b, 1024, torch.float32))[0].sum().item())
    drawn = int((fi_n >= 0).sum().item())
    n_lists_bytes = 4 * (ids_run.numel() + lists_n.starts.numel() + lists_n.run_counts.numel()
                         + n_big_n * 5 + lists_n.gcount.numel())
    maps_bound = bound(
        front_pairs * N_OPS_EDGE + inside_pairs * N_OPS_DEPTH
        + drawn * (N_OPS_SAMPLE + 24 * N_OPS_TAP),
        4 * (rows_n.numel() + tex_n.numel()) + n_lists_bytes + 4 * 20 * HW_n)
    # face_index of every pixel; weight 3, depth 1, zcorn 3 and gradient 3
    # of the drawn pixels; the gradient out
    texbwd_bound = bound(
        drawn * (N_OPS_SAMPLE + T3_n * N_OPS_TEXROW),
        4 * HW_n + 4 * 10 * drawn + 4 * F_n * T3_n)
    e_rows, out_cells, in_cells, longest, pos_cells = nplain.edge_scan_census(
        fv_n, fi_n, 1024, [[(rgb_n[0, ..., k], gr_n[0, ..., k]) for k in range(3)]])
    edgebwd_bound = bound(
        (out_cells + in_cells) * 3 * N_OPS_CHANNEL + pos_cells * N_OPS_CELL + e_rows * 40,
        4 * (F_n * 6 + 7 * HW_n + F_n * 9))
    log(f'  counts: {int(front_n.sum().item())} front faces, {won.numel()} drawn; tile-list '
        f'pairs with a front face {front_pairs:,}, inside {inside_pairs:,}, drawn pixels '
        f'{drawn:,}; busiest tile {int(lists_n.counts.max().item())} faces; edge scans: '
        f'{e_rows:,} rows, {out_cells:,} cells outwards, {in_cells:,} inwards, '
        f'{pos_cells:,} with a positive difference, the longest item {longest:,} cells '
        f'({longest / max(out_cells + in_cells, 1):.2e} of all, mean item '
        f'{(out_cells + in_cells) / max(int(front_n.sum().item()) * 6, 1):,.0f})')
    for name, b in (('n3mr_maps', maps_bound), ('n3mr_texbwd', texbwd_bound),
                    ('n3mr_edgebwd', edgebwd_bound)):
        log(f'  bound {name}: {b[0]:.6f} ms by {b[1]}: {b[2]}')
    log(f'  kernels alone: z-buffer {maps_ms:.4f} ms, texture gradient {texbwd_ms:.4f} ms, '
        f'edge gradient {edgebwd_ms:.4f} ms (its inputs, plain torch: {edge_prep_ms:.4f} ms); '
        f'binning {n_bin_ms:.3f} ms  [{smi}]')
    log(f'  plain versions: z-buffer on {SAMPLES} pixels {maps_plain_ms:.1f} ms, texture '
        f'gradient (whole frame) {texbwd_plain_ms:.3f} ms, index_add_ of its rows '
        f'{texbwd_lib_ms:.3f} ms, edge sweep on {ids_n.numel()} faces {edge_plain_ms:.1f} ms  [{smi}]')
    log(f'  render_mesh forward {n_render_ms:.3f} ms/frame (78,948 faces with fill_back); '
        f'rasterize fwd+bwd step {n_step_ms:.3f} ms; with anti-aliasing {n_aa_ms:.3f} ms  [{smi}]')

    # ---- 10. a trainer: demo 4's texture fit ---------------------------------
    log('phase 10: demo 4, textures of a 1,300-face sphere, 256 px, texture size 4')
    fitter = Renderer(camera_mode='look_at', perspective=False, light_intensity_directionals=0.0,
                      light_intensity_ambient=1.0, dr_type='n3mr')
    verts_f = torch.tensor(v_s, device=dev)[None] * 0.6 / 0.5
    faces_f = torch.tensor(f_s, device=dev)[None]
    tex_goal = n3mr_texture(1, f_s.shape[0], 4, SEED + 9)
    tex_fit = torch.ones((1, f_s.shape[0], 4, 4, 4, 3), device=dev, requires_grad=True)
    opt_f = torch.optim.Adam([tex_fit], lr=0.03, betas=(0.5, 0.999))
    rng_f = np.random.RandomState(SEED + 1)
    n_zero_counts()
    fit_losses, t_fit = [], []
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        fitter.transform.set_eyes_from_angles(2.732, 0, float(rng_f.uniform(0, 360)))
        with torch.no_grad():
            goal = fitter(verts_f, faces_f, tex_goal)
        opt_f.zero_grad()
        loss = ((fitter(verts_f, faces_f, torch.tanh(tex_fit)) - goal) ** 2).sum()
        loss.backward()
        opt_f.step()
        torch.cuda.synchronize()
        t_fit.append((time.perf_counter() - t0) * 1e3)
        fit_losses.append(loss.item())
    fit_counts = n_read_counts()
    # a step renders the goal and the fit; only textures ask for a gradient,
    # so the edge kernel is not launched
    if fit_counts != {'n3mr_maps': 2 * N_TRAIN_STEPS, 'n3mr_texbwd': N_TRAIN_STEPS,
                      'n3mr_edgebwd': 0}:
        raise AssertionError(f'N3MR launches of {N_TRAIN_STEPS} fitting steps: {fit_counts}')
    first, last = np.mean(fit_losses[:3]), np.mean(fit_losses[-3:])
    if not (np.isfinite(fit_losses).all() and last < first
            and torch.isfinite(tex_fit).all() and goal.shape == (1, 3, 256, 256)):
        raise AssertionError(f'the texture fit did not fall: {fit_losses}')
    log(f'  launches {fit_counts} for {N_TRAIN_STEPS} steps; loss {fit_losses[0]:.2f} -> '
        f'{fit_losses[-1]:.2f} (mean of 3: {first:.2f} -> {last:.2f}); step '
        f'{np.median(t_fit[2:]):.3f} ms (median, host clock)  [{smi}]')

    no_pxg('phases 8-10')

    # ---- 10b. the fixed-order sums ----------------------------------------
    log('phase 10b: fixed-order sums at full width (vertex normals, N3MR depth gradient)')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda_r, torch_impl as ntorch_r
    v_r = torch.tensor(v, device=dev)[None]
    f_r = torch.tensor(f, device=dev)[None]
    gen.manual_seed(SEED + 12)
    g_r = torch.randn(v_r.shape, generator=gen, device=dev)
    zero_counts()
    runs_r = []
    for _ in range(2):
        x_r = v_r.clone().requires_grad_(True)
        nrm = vertex_normals_fn(x_r, f_r)
        (nrm * g_r).sum().backward()
        runs_r.append((nrm, x_r.grad))
    torch.cuda.synchronize()
    if segment_sum.launch_segment_sum.launches != 2:
        raise AssertionError(f'vertex normals: {segment_sum.launch_segment_sum.launches} '
                             f'segment-sum launches for 2 calls')
    if not (torch.equal(runs_r[0][0], runs_r[1][0]) and torch.equal(runs_r[0][1], runs_r[1][1])):
        raise AssertionError('vertex normals: two runs differ in their bits')
    x_c = v_r.cpu().requires_grad_(True)
    nrm_c = vertex_normals_fn(x_c, f_r.cpu())
    (nrm_c * g_r.cpu()).sum().backward()
    e_nrm = (runs_r[0][0].cpu() - nrm_c).abs().max().item()
    f_ng, e_ng = grad_beyond(runs_r[0][1].cpu(), x_c.grad)
    if not e_nrm <= 1e-5:
        raise AssertionError(f'vertex normals vs the CPU plain version: max {e_nrm:.3g}')
    check('vertex normals gradient vs the CPU plain version', f_ng, 0.0)
    _, fi_r, wt_r, dp_r, finv_r, zc_r, _ = ncuda_r.forward_maps(fv_n, None, 1024, 0.1, 100.0,
                                                                 1e-3)
    gen.manual_seed(SEED + 13)
    gd_r = torch.randn(dp_r.shape, generator=gen, device=dev)
    dep = [ntorch_r.backward_depth(fv_n, fi_r, finv_r, wt_r, dp_r, zc_r, gd_r) for _ in range(2)]
    torch.cuda.synchronize()
    if segment_sum.launch_segment_sum.launches != 4 or not torch.equal(dep[0], dep[1]):
        raise AssertionError('N3MR depth gradient: not one launch per call, or two runs differ')
    dep_c = ntorch_r.backward_depth(*(t.cpu() for t in (fv_n, fi_r, finv_r, wt_r, dp_r, zc_r,
                                                        gd_r)))
    f_dep, e_dep = grad_beyond(dep[0].cpu(), dep_c)
    check('N3MR depth gradient vs the CPU plain version', f_dep, 0.0)
    so_n = segment_sum.segment_order(f_r.reshape(-1), v_r.shape[1])
    rows_n = torch.randn((f_r.numel(), 3), generator=gen, device=dev)
    seg_ms = timed(lambda: segment_sum.launch_segment_sum(rows_n, so_n), reps=30)
    seg_lib_ms = timed(lambda: torch.zeros((v_r.shape[1], 3), device=dev).index_add_(
        0, so_n.seg, rows_n), reps=30)
    log(f'  vertex normals of {f_r.shape[1]:,} faces: bit-equal twice with their gradient, '
        f'max {e_nrm:.2g} from the CPU plain version (gradient max {e_ng:.2g} of scale); '
        f'depth gradient at 1024 px: bit-equal twice, max {e_dep:.2g} of scale from the CPU '
        f'plain version; the normals\' sum alone {seg_ms:.4f} ms, index_add_ {seg_lib_ms:.4f} '
        f'ms  [{smi}]')


    # ---- 11. the dir route (JR_DIR_MAX) ----------------------------------
    log('phase 11a: dir kernels vs plain and vs the binned route, whole images')
    d_err = {'fwd': 0.0, 'bwd': 0.0}
    same_min = {'count': 1.0, 'thr': 1.0}

    def compare_dir(tag, fv, tex, p):
        """Both dir kernels against their plain versions and against the
        binned route on the same inputs, whole image; the backward twice."""
        surface = p.texture_type == 'surface'
        if surface:
            tex = tie_symmetric(tex)
        with_thr = torch_impl.use_threshold(p, fv.shape[1])
        table = dir_impl.prep_dir(fv, tex, p)
        img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, p, with_thr)
        torch.cuda.synchronize()
        want, ag_w, cnt_w, thr_w = dir_impl.fwd_plain(table, p, with_thr, chunk_pairs=1 << 24)
        f_rgb, e_rgb = beyond(img[:, :3], want[:, :3], TOL, pixel_dim=1)
        f_a, e_a = beyond(img[:, 3], want[:, 3], TOL)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        check(f'{tag} count', beyond(cnt.float(), cnt_w.float(), 0)[0])
        if p.aggr_func_rgb == 'hard':
            check(f'{tag} face index', beyond(ag[:, 1], ag_w[:, 1], 0)[0])
        if not torch.isfinite(img).all():
            raise AssertionError(f'{tag}: non-finite output')
        msg = f'  {tag}: rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), alpha {f_a:.4f}'
        e_thr = 0.0
        if with_thr:
            bad = (thr - thr_w).abs() > THR_RTOL * thr_w.abs()
            check(f'{tag} threshold', bad.float().mean().item(), THR_FRAC)
            if not (thr[cnt <= p.max_faces_id] == p.far).all():
                raise AssertionError(f'{tag}: a pixel with at most K candidates has a threshold')
            e_thr = (thr - thr_w).abs().max().item()
            msg += f', thr {bad.float().mean().item():.6f} beyond'
        # the binned route on the same inputs: counts and thresholds to the bit
        inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
        b_img, b_ag, b_cnt = cuda_impl.launch(inputs, p)
        b_thr = cuda_impl.topk_threshold(fv, p, inputs, b_cnt)
        same_cnt = (b_cnt == cnt).float().mean().item()
        same_min['count'] = min(same_min['count'], same_cnt)
        check(f'{tag} count vs binned', 1.0 - same_cnt, 1e-4)
        msg += f'; vs binned: count {same_cnt:.6f} equal'
        if with_thr:
            same_thr = (b_thr == thr).float().mean().item()
            same_min['thr'] = min(same_min['thr'], same_thr)
            check(f'{tag} threshold vs binned', 1.0 - same_thr, 1e-4)
            msg += f', thr {same_thr:.6f} equal'
        f_b, e_b = beyond(img, b_img, TOL, pixel_dim=1)
        check(f'{tag} image vs binned', f_b)
        # the backward, twice, against its plain version (with the plain
        # threshold) and the binned backward (with the binned threshold)
        gen.manual_seed(SEED + 3)
        g = torch.randn(img.shape, generator=gen, device=dev)
        gf, gt = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        gf2, gt2 = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        torch.cuda.synchronize()
        if not (torch.equal(gf, gf2) and torch.equal(gt, gt2)):
            raise AssertionError(f'{tag}: two runs of the dir backward differ in their bits')
        wf, wt = dir_impl.bwd_plain(table, img, ag, thr_w, g, p, chunk_pairs=1 << 22)
        kf, kt = cuda_impl.soft_rasterize_bwd(fv, tex, b_img, b_ag, b_thr, g, p, inputs)
        kt = kt.reshape(gt.shape)
        if surface:
            gt, wt, kt = fold_ties(gt), fold_ties(wt), fold_ties(kt)
        (f_f, e_f), (f_t, e_t) = grad_beyond(gf, wf), grad_beyond(gt, wt)
        (k_f, _), (k_t, _) = grad_beyond(gf, kf), grad_beyond(gt, kt)
        check(f'{tag} face gradient', f_f, GRAD_FRAC)
        check(f'{tag} texture gradient', f_t, GRAD_FRAC)
        check(f'{tag} face gradient vs binned', k_f, GRAD_FRAC)
        check(f'{tag} texture gradient vs binned', k_t, GRAD_FRAC)
        moves = p.aggr_func_rgb == 'softmax' or (p.dist_func != 'hard'
                                                  and p.aggr_func_alpha != 'hard')
        if moves and not gf.abs().max() > 0:
            raise AssertionError(f'{tag}: zero face gradient')
        d_err['fwd'] = max(d_err['fwd'], e_rgb, e_a, e_thr)
        d_err['bwd'] = max(d_err['bwd'], e_f, e_t)
        log(msg + f'; face grad {f_f:.6f} beyond (max {e_f:.2g} of scale), texture grad '
            f'{f_t:.6f} (max {e_t:.2g}); vs binned {k_f:.6f} / {k_t:.6f}; bit-equal twice')
        return gf

    for dist, rgb, alpha in configs:
        p = make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                        aggr_func_alpha=alpha, sigma_val=1e-4, gamma_val=1e-3)
        compare_dir(f'sphere 128 {dist}/{rgb}/{alpha}', fv_mid, tex_mid, p)
    compare_dir('sphere 256 renderer defaults', fv_mid, tex_mid, make_params(image_size=256))
    for T in (1, 4, 25):
        fv, tex = soup(400, 1, T, SEED + T)
        compare_dir(f'soup 128 T={T}', fv, tex,
                    make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3))
    fv, tex = soup(400, 1, 3, SEED)
    compare_dir('soup 64 vertex, background, fill_back off', fv, tex.reshape(1, 400, 3, 3),
                make_params(image_size=64, texture_type='vertex', fill_back=False,
                            background_color=(0.2, 0.4, 0.6), sigma_val=1e-4, gamma_val=0.1))
    for K in (1, 4, 16):
        compare_dir(f'soup 128 B=2 K={K}', fv_b2, tex_b2,
                    make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                                max_faces_per_pixel_for_grad=K))
    # K = 40 is past the per-thread list: the forward's bisection
    compare_dir('dense soup 128 K=40, bisection', fv_dense, tex_dense,
                make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                            max_faces_per_pixel_for_grad=40))
    compare_dir("soup 120 (tile 8) grad_mode='full'", fv_b2, tex_b2,
                make_params(image_size=120, sigma_val=1e-4, gamma_val=1e-3, grad_mode='full'))
    # two faces over most of the screen: many bands of the backward each
    fv_big = fv_b2.clone()
    fv_big[:, 0, 0::3] = torch.tensor([-0.9, 0.9, 0.0], device=dev)
    fv_big[:, 0, 1::3] = torch.tensor([-0.9, -0.8, 0.9], device=dev)
    fv_big[:, 1, 0::3] = torch.tensor([-0.8, 0.7, -0.9], device=dev)
    fv_big[:, 1, 1::3] = torch.tensor([0.8, 0.9, -0.7], device=dev)
    gf_big = compare_dir('soup 256 screen-filling faces', fv_big, tex_b2,
                         make_params(image_size=256, sigma_val=1e-4, gamma_val=1e-3))
    if not gf_big[:, :2].abs().amax() > 0:
        raise AssertionError('the screen-filling faces have no gradient')
    # exact depth ties (checks.tie_soup): faces on z = 4 whose ties the
    # lowest original id must win, wherever the Morton order puts it
    tie = torch.tensor(tie_soup(), device=dev)
    p_tie = make_params(image_size=32, dist_func='hard', aggr_func_rgb='hard',
                        aggr_func_alpha='hard')
    tie_table = dir_impl.prep_dir(tie, textures(4, 1, SEED + 11), p_tie)
    if tie_table.ids[0].tolist() == sorted(tie_table.ids[0].tolist()):
        raise AssertionError(f'tie soup: Morton order {tie_table.ids[0].tolist()} is the id order')
    compare_dir('tie soup 32, hard', tie, textures(4, 1, SEED + 11), p_tie)
    _, ag_tie, _, _ = dir_impl.launch_dir_fwd(tie_table, p_tie, False)
    won = set(ag_tie[0, 1][ag_tie[0, 1] >= 0].long().tolist())
    if won != {0, 1, 3}:
        raise AssertionError(f'tie soup: faces {won} won')
    log(f'  counts and thresholds equal to the binned route on at least '
        f'{same_min["count"]:.6f} / {same_min["thr"]:.6f} of pixels in every case')

    log('phase 11b: the dir route at full width, render_mesh and steps at 1024 px')

    def dir_full_width(tag, rings, segs):
        """bench.py's row on a UV sphere at 1024 px on the dir route: 8
        frames, 8 steps of soft_rasterize and of render_mesh, one launch of
        each dir wrapper per step and none of the binned ones; 4,096 pixels
        and their gradient against the plain versions; each kernel timed
        alone and bounded; the steps on both routes in turns."""
        v_m, f_m = uv_sphere(rings, segs)
        F = f_m.shape[0]
        gen.manual_seed(SEED)
        tex_m = torch.rand((1, F, 25, 3), generator=gen, device=dev)
        mesh_m = Mesh(v_m, f_m, textures=tex_m, texture_res=5, texture_type='surface')
        out = {'faces': F}
        with dir_impl.with_dir_max(4096):
            zero_counts()
            with torch.no_grad():
                for az in azimuths:
                    mesh_m.reset_()
                    renderer.transform.set_eyes_from_angles(2.732, 30, az)
                    alpha, rgb = renderer.render_mesh(mesh_m, mode=None)
                    if not (torch.isfinite(alpha).all() and alpha.gt(0.5).float().mean() > 0.05):
                        raise AssertionError(f'{tag} azimuth {az}: non-finite or empty frame')
            torch.cuda.synchronize()
            if read_dir() != {'softras_dir_fwd': FRAMES, 'softras_dir_bwd': 0} \
                    or any(read_counts().values()):
                raise AssertionError(f'{tag}: launches of {FRAMES} frames: {read_dir()}, '
                                     f'{read_counts()}')
            no_pxg(f'phase 11b {tag}')
            mesh_m.reset_()
            renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[1])
            with torch.no_grad():
                lit_m = renderer.transform(renderer.lighting(mesh_m, renderer.transform.eyes))
            fv_m = lit_m.face_vertices.reshape(1, -1, 9).contiguous()
            tex_l = lit_m.face_textures.contiguous()
            fv_l = fv_m.clone().requires_grad_(True)
            tx_l = tex_l.clone().requires_grad_(True)

            def raster_step(i=0):
                fv_l.grad = tx_l.grad = None
                soft_rasterize(fv_l, tx_l, image_size=1024, sigma_val=1e-5,
                               gamma_val=1e-4).sum().backward()

            v_l = torch.tensor(v_m, device=dev).requires_grad_(True)
            t_l = tex_m.clone().requires_grad_(True)
            mesh_l = Mesh(v_l, f_m, textures=t_l, texture_res=5, texture_type='surface')

            def mesh_step(i=1):
                v_l.grad = t_l.grad = None
                mesh_l.reset_()
                renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i % FRAMES])
                alpha, rgb = renderer.render_mesh(mesh_l, mode=None)
                (alpha.sum() + rgb.sum()).backward()

            for name, step, grads in (('soft_rasterize', raster_step, (fv_l, tx_l)),
                                      ('render_mesh', mesh_step, (v_l, t_l))):
                zero_counts()
                for i in range(STEPS):
                    step(i)
                    want = {'softras_dir_fwd': i + 1, 'softras_dir_bwd': i + 1}
                    if read_dir() != want or any(read_counts().values()):
                        raise AssertionError(f'{tag} {name}: launches after step {i + 1}: '
                                             f'{read_dir()}, {read_counts()}')
                    no_pxg(f'phase 11b {tag} {name}')
                torch.cuda.synchronize()
                out[f'{name}_launches'] = read_dir()
                for leaf in grads:
                    if leaf.grad is None or not (torch.isfinite(leaf.grad).all()
                                                 and leaf.grad.abs().max() > 0):
                        raise AssertionError(f'{tag} {name}: a gradient is missing, '
                                             f'non-finite or zero')

            # 4,096 pixels of the step's frame and their gradient
            p_m = make_params(image_size=1024)
            tex_s = tie_symmetric(tex_l)
            table = dir_impl.prep_dir(fv_m, tex_s, p_m)
            img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, p_m, True)
            face_t, tex_t = dir_impl.table_faces(table, p_m)
            idx = torch.unique(sample_pixels(1024)[0])
            xk, yk = torch_impl.pixel_centers(idx // 1024, idx % 1024, 1024)

            def at(x):
                return x.reshape(1, x.shape[1], -1)[:, :, idx].permute(0, 2, 1).contiguous()

            def plain_fwd():
                return torch_impl.forward_pixels(face_t, tex_t, p_m, xk, yk, chunk_pairs=1 << 24,
                                                 ids=table.ids)

            col, _, cnt_w = plain_fwd()
            f_rgb, e_rgb = beyond(at(img)[..., :3], col[..., :3], TOL, pixel_dim=-1)
            f_a, e_a = beyond(at(img)[..., 3], col[..., 3], TOL)
            check(f'{tag} sampled rgb', f_rgb)
            check(f'{tag} sampled alpha', f_a)
            check(f'{tag} sampled count', beyond(at(cnt[:, None].float())[..., 0],
                                                 cnt_w.float(), 0)[0])
            thr_px = torch_impl.topk_threshold(face_t, p_m, xk, yk, chunk_pairs=1 << 24)
            f_thr = ((thr_px - at(thr[:, None])[..., 0]).abs()
                     > THR_RTOL * thr_px.abs()).float().mean().item()
            check(f'{tag} sampled threshold', f_thr, THR_FRAC)
            gen.manual_seed(SEED + 2)
            g_px = torch.randn((1, idx.numel(), 4), generator=gen, device=dev)
            g_img = torch.zeros((1, 4, 1024 * 1024), device=dev)
            g_img[:, :, idx] = g_px.permute(0, 2, 1)
            g_img = g_img.reshape(1, 4, 1024, 1024)
            gf_k, gt_k = dir_impl.launch_dir_bwd(table, img, ag, thr, g_img, p_m)
            back = table.inv.long()

            def plain_bwd():
                gf, gt = torch_impl.backward_pixels(face_t, tex_t, at(img), at(ag), g_px, p_m,
                                                    xk, yk, thr=thr_px, chunk_pairs=1 << 22,
                                                    ids=table.ids)
                return (gf.gather(1, back[..., None].expand_as(gf)),
                        gt.gather(1, back[..., None, None].expand_as(gt)))

            gf_w, gt_w = plain_bwd()
            (f_f, e_f), (f_t, e_t) = grad_beyond(gf_k, gf_w), grad_beyond(
                fold_ties(gt_k), fold_ties(gt_w))
            check(f'{tag} sampled face gradient', f_f, GRAD_FRAC)
            check(f'{tag} sampled texture gradient', f_t, GRAD_FRAC)
            out['fwd_err'] = max(e_rgb, e_a, (thr_px - at(thr[:, None])[..., 0]).abs().max().item())
            out['bwd_err'] = max(e_f, e_t)
            log(f'  {tag}: launches {out["soft_rasterize_launches"]} and '
                f'{out["render_mesh_launches"]} for {STEPS} steps, {FRAMES} for {FRAMES} frames, '
                f'none binned; {idx.numel()} pixels: rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), '
                f'alpha {f_a:.4f}, threshold {f_thr:.6f}; their gradient: face {f_f:.6f} beyond '
                f'(max {e_f:.2g} of scale), texture {f_t:.6f} (max {e_t:.2g})')

            # each kernel alone, its plain version on the sample, the prep
            g_ones = torch.ones_like(img)
            out['fwd_ms'] = timed(lambda: dir_impl.launch_dir_fwd(table, p_m, True), reps=30)
            out['fwd_nothr_ms'] = timed(lambda: dir_impl.launch_dir_fwd(table, p_m, False),
                                        reps=30)
            out['bwd_ms'] = timed(lambda: dir_impl.launch_dir_bwd(table, img, ag, thr, g_ones,
                                                                  p_m), reps=30)
            out['prep_ms'] = timed(lambda: dir_impl.prep_dir(fv_m, tex_s, p_m))
            out['fwd_plain_ms'] = timed(plain_fwd, reps=2, warm=1)
            out['bwd_plain_ms'] = timed(plain_bwd, reps=2, warm=1)
            out['plain_on'] = f'{idx.numel()} of {1024 * 1024} pixels'

        # the steps on both routes in turns: binned, dir, dir, binned
        times = {'binned': [], 'dir': []}
        for route in ('binned', 'dir', 'dir', 'binned'):
            with dir_impl.with_dir_max(4096 if route == 'dir' else 0):
                t_r = timed(raster_step, reps=STEPS)
                t0 = time.perf_counter()
                for i in range(STEPS):
                    mesh_step(i)
                torch.cuda.synchronize()
                t_m = (time.perf_counter() - t0) * 1e3 / STEPS
                t0 = time.perf_counter()
                with torch.no_grad():
                    for i in range(FRAMES):
                        mesh_m.reset_()
                        renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i])
                        renderer.render_mesh(mesh_m, mode='rgb')
                torch.cuda.synchronize()
                times[route].append((t_r, t_m, (time.perf_counter() - t0) * 1e3 / FRAMES))
        out['times'] = times

        # the bounds, from this frame's pair counts: the function's work (the
        # pairs in a bbox, inside, candidates, within the threshold), not the
        # design's per-tile bbox tests of the whole table; the backward reads
        # the 11 maps of the pixels with a candidate only
        in_b = cuda_impl.prepare(fv_m, tex_s, p_m)
        census = pair_census(fv_m, p_m, in_b.lists, cnt)
        HW = 1024 * 1024
        GC = 9 + tex_s[0, 0].numel()
        table_bytes = 4 * (table.rows.numel() + table.bbox.numel() + table.ids.numel())
        out['fwd_bound'] = bound(
            census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE
            + census['candidates'] * (OPS_SHADE + OPS_LIST),
            table_bytes + 4 * 8 * HW)
        out['bwd_bound'] = bound(
            census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE
            + census['candidates'] * OPS_DEPTH + census['within_thr'] * OPS_GRAD,
            table_bytes + 4 * 11 * census['drawn'] + 4 * F * GC)
        out['census'] = census
        med = {r: [float(np.median([t[k] for t in ts])) for k in range(3)]
               for r, ts in times.items()}
        log(f'  {tag}: pairs {census}')
        for name in ('fwd', 'bwd'):
            b = out[f'{name}_bound']
            log(f'  {tag} bound softras_dir_{name}: {b[0]:.6f} ms by {b[1]}: {b[2]}')
        log(f'  {tag} kernels alone: forward {out["fwd_ms"]:.4f} ms (without the threshold '
            f'{out["fwd_nothr_ms"]:.4f}), backward {out["bwd_ms"]:.4f} ms; prep '
            f'{out["prep_ms"]:.4f} ms; plain on {out["plain_on"]}: forward '
            f'{out["fwd_plain_ms"]:.1f} ms, backward {out["bwd_plain_ms"]:.1f} ms  [{smi}]')
        log(f'  {tag} in turns (binned, dir, dir, binned), ms: soft_rasterize step / '
            f'render_mesh step / render_mesh frame: {times}; medians binned {med["binned"]}, '
            f'dir {med["dir"]}  [{smi}]')
        return out

    small = dir_full_width('288 faces', 13, 12)
    dir_counts = small['soft_rasterize_launches']
    middle = dir_full_width('3,330 faces', 38, 45)

    log('phase 11c: demo 2 on the dir route, 120 views at 64 px, 1,300 faces')
    with dir_impl.with_dir_max(4096):
        model_d = deform.DeformModel(v_s, f_s).to(dev)
        zero_counts()
        grad_dir = first_grad(model_d)
        f_g, e_g = grad_beyond(grad_dir, grad_binned)
        check('demo 2 first gradient vs the binned route', f_g, GRAD_FRAC)
        optimizer_d = torch.optim.Adam(model_d.parameters(), lr=0.01, betas=(0.5, 0.99))
        zero_counts()
        losses_d, t_dir = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, sil = deform.deform_step(model_d, optimizer_d, trainer, targets)
            torch.cuda.synchronize()
            t_dir.append((time.perf_counter() - t0) * 1e3)
            losses_d.append(loss.item())
        train_dir = read_dir()
        if train_dir != dict.fromkeys(dir_wrappers, TRAIN_STEPS) or any(read_counts().values()):
            raise AssertionError(f'dir launches of {TRAIN_STEPS} training steps: {read_dir()}, '
                                 f'{read_counts()}')
        if not (np.isfinite(losses_d).all() and losses_d[-1] < losses_d[0]):
            raise AssertionError(f'the training loss on the dir route did not fall: {losses_d}')
        no_pxg('phase 11c')
    # the two routes' stages on the rasterizer's inputs of the first step
    tex_ts = tie_symmetric(tex_t)
    tab_t = dir_impl.prep_dir(fv_t, tex_ts, p_t)
    img_t, ag_t, _, thr_t = dir_impl.launch_dir_fwd(tab_t, p_t, True)
    in_t = cuda_impl.prepare(fv_t, tex_ts, p_t, for_grad=True)
    bimg_t, bag_t, bcnt_t = cuda_impl.launch(in_t, p_t)
    bthr_t = cuda_impl.launch_thr(in_t, bcnt_t, p_t)
    g_t = torch.ones_like(img_t)
    stages_t = {
        'dir prep': timed(lambda: dir_impl.prep_dir(fv_t, tex_ts, p_t)),
        'dir forward': timed(lambda: dir_impl.launch_dir_fwd(tab_t, p_t, True)),
        'dir backward': timed(lambda: dir_impl.launch_dir_bwd(tab_t, img_t, ag_t, thr_t, g_t,
                                                              p_t)),
        'binned prep': timed(lambda: cuda_impl.prepare(fv_t, tex_ts, p_t, for_grad=True)),
        'binned forward + threshold': timed(lambda: (cuda_impl.launch(in_t, p_t),
                                                     cuda_impl.launch_thr(in_t, bcnt_t, p_t))),
        'binned backward + reduction': timed(lambda: cuda_impl.soft_rasterize_bwd(
            fv_t, tex_ts, bimg_t, bag_t, bthr_t, g_t, p_t, in_t))}
    log('  stages on the first step\'s inputs, ms (CUDA events): '
        + ', '.join(f'{k} {v:.4f}' for k, v in stages_t.items()) + f'  [{smi}]')
    log(f'  first gradient vs the binned route: {f_g:.6f} of entries beyond (max {e_g:.2g} of '
        f'scale); launches {train_dir} for {TRAIN_STEPS} steps; loss {losses_d[0]:.6f} -> '
        f'{losses_d[-1]:.6f}; step {np.median(t_dir[2:]):.3f} ms on the dir route, '
        f'{np.median(t_train[2:]):.3f} ms binned (phase 7; medians, host clock)  [{smi}]')

    # ---- 12. the pxg route (JR_LAYOUT=pxg) ---------------------------------
    log('phase 12a: pxg kernels vs plain and vs the binned route, whole images')
    g_err = dict.fromkeys(['fwd', 'combine', 'thr', 'bwd', 'sum'], 0.0)
    g_same = {'thr': 1.0}

    def compare_pxg(tag, fv, tex, p, group=pxg_impl.GROUP):
        """The pxg kernels against their plain versions and against the
        binned route on the same inputs, whole image; the backward twice."""
        surface = p.texture_type == 'surface'
        if surface:
            tex = tie_symmetric(tex)
        with_thr = torch_impl.use_threshold(p, fv.shape[1])
        pin = pxg_impl.prep_pxg(fv, tex, p, for_grad=True, group=group)
        parts, depths = pxg_impl.launch_pxg_fwd(pin, p, with_thr)
        img, ag, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
        torch.cuda.synchronize()
        w_parts, w_depths = pxg_impl.fwd_partials_plain(pin, p, with_thr, chunk_pairs=1 << 24)
        want, ag_w, cnt_w = pxg_impl.combine_plain(pin, w_parts, p)
        f_rgb, e_rgb = beyond(img[:, :3], want[:, :3], TOL, pixel_dim=1)
        f_a, e_a = beyond(img[:, 3], want[:, 3], TOL)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        check(f'{tag} count', beyond(cnt.float(), cnt_w.float(), 0)[0])
        if p.aggr_func_rgb == 'hard':
            check(f'{tag} face index', beyond(ag[:, 1], ag_w[:, 1], 0)[0])
        if not torch.isfinite(img).all():
            raise AssertionError(f'{tag}: non-finite output')
        # the combine alone, on the kernel's partials
        c_img, _, c_cnt = pxg_impl.combine_plain(pin, parts, p)
        f_c, e_c = beyond(img, c_img, 1e-5, pixel_dim=1)
        check(f'{tag} combine', f_c, 0.0)
        if not torch.equal(cnt, c_cnt):
            raise AssertionError(f'{tag}: the combine\'s counts differ from its plain version')
        msg = (f'  {tag}: {pin.items.shape[0]} items; rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), '
               f'alpha {f_a:.4f}, combine max {e_c:.2g}')
        # the binned route on the same inputs: counts on every pixel, the
        # threshold on 99.99% of them, to the bit
        inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
        b_img, b_ag, b_cnt = cuda_impl.launch(inputs, p)
        b_thr = cuda_impl.topk_threshold(fv, p, inputs, b_cnt)
        if not torch.equal(cnt, b_cnt):
            raise AssertionError(f'{tag}: counts differ from the binned route\'s')
        e_thr = 0.0
        thr = thr_w = None
        if with_thr:
            thr = pxg_impl.launch_pxg_thr(pin, depths, cnt, p)
            thr_w = pxg_impl.thr_plain(pin, w_depths, cnt, p)
            bad = (thr - thr_w).abs() > THR_RTOL * thr_w.abs()
            check(f'{tag} threshold', bad.float().mean().item(), THR_FRAC)
            if not (thr[cnt <= p.max_faces_id] == p.far).all():
                raise AssertionError(f'{tag}: a pixel with at most K candidates has a threshold')
            e_thr = (thr - thr_w).abs().max().item()
            same_thr = (b_thr == thr).float().mean().item()
            g_same['thr'] = min(g_same['thr'], same_thr)
            check(f'{tag} threshold vs binned', 1.0 - same_thr, 1e-4)
            msg += (f', thr {bad.float().mean().item():.6f} beyond, {same_thr:.6f} equal to '
                    f'binned ({int(pxg_impl.overfull_tiles(pin, cnt, p).numel())} overfull tiles)')
        f_b, _ = beyond(img, b_img, TOL, pixel_dim=1)
        check(f'{tag} image vs binned', f_b)
        msg += f'; vs binned: counts equal, image {f_b:.4f} beyond'
        # the backward, twice; the sum against its plain version on the same
        # rows; the whole gradient against the plain one (with the plain
        # threshold) and the binned one (with the binned threshold)
        gen.manual_seed(SEED + 3)
        g = torch.randn(img.shape, generator=gen, device=dev)
        grows = pxg_impl.launch_pxg_bwd(pin, img, ag, thr, g, p)
        gf, gt = tiled.face_sum(pin, grows, p)
        gf2, gt2 = pxg_impl.backward(pin, img, ag, thr, g, p)
        torch.cuda.synchronize()
        if not (torch.equal(gf, gf2) and torch.equal(gt, gt2)):
            raise AssertionError(f'{tag}: two runs of the pxg backward differ in their bits')
        sf_, st_ = tiled.sum_plain(pin, grows, p)
        (f_sf, e_sf), (f_st, e_st) = grad_beyond(gf, sf_), grad_beyond(gt, st_)
        check(f'{tag} face sum', max(f_sf, f_st), 0.0)
        wf, wt = torch_impl.soft_rasterize_bwd_plain(fv, tex, img, ag, thr_w, g, p,
                                                     chunk_pairs=1 << 22)
        kf, kt = cuda_impl.soft_rasterize_bwd(fv, tex, b_img, b_ag, b_thr, g, p, inputs)
        wt, kt = wt.reshape(gt.shape), kt.reshape(gt.shape)
        if surface:
            gt, wt, kt = fold_ties(gt), fold_ties(wt), fold_ties(kt)
        (f_f, e_f), (f_t, e_t) = grad_beyond(gf, wf), grad_beyond(gt, wt)
        (k_f, _), (k_t, _) = grad_beyond(gf, kf), grad_beyond(gt, kt)
        check(f'{tag} face gradient', f_f, GRAD_FRAC)
        check(f'{tag} texture gradient', f_t, GRAD_FRAC)
        check(f'{tag} face gradient vs binned', k_f, GRAD_FRAC)
        check(f'{tag} texture gradient vs binned', k_t, GRAD_FRAC)
        moves = p.aggr_func_rgb == 'softmax' or (p.dist_func != 'hard'
                                                  and p.aggr_func_alpha != 'hard')
        if moves and not gf.abs().max() > 0:
            raise AssertionError(f'{tag}: zero face gradient')
        for k, e in (('fwd', max(e_rgb, e_a)), ('combine', e_c), ('thr', e_thr),
                     ('bwd', max(e_f, e_t)), ('sum', max(e_sf, e_st))):
            g_err[k] = max(g_err[k], e)
        log(msg + f'; face grad {f_f:.6f} beyond (max {e_f:.2g} of scale), texture grad '
            f'{f_t:.6f} (max {e_t:.2g}); vs binned {k_f:.6f} / {k_t:.6f}; sum max '
            f'{max(e_sf, e_st):.2g}; bit-equal twice')
        return pin, cnt, gf

    with route.with_layout('pxg'):
        for dist, rgb, alpha in configs:
            p = make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                            aggr_func_alpha=alpha, sigma_val=1e-4, gamma_val=1e-3)
            compare_pxg(f'sphere 128 {dist}/{rgb}/{alpha}', fv_mid, tex_mid, p)
        pin_d, cnt_d, _ = compare_pxg('sphere 256 renderer defaults', fv_mid, tex_mid,
                                      make_params(image_size=256))
        # items of 8 faces: every tile with more than 8 faces splits
        pin_s, _, _ = compare_pxg('sphere 128 renderer defaults, items of 8 faces', fv_mid,
                                  tex_mid, make_params(image_size=128), group=8)
        n_split = int((pin_s.item_off[1:] - pin_s.item_off[:-1]).gt(1).sum().item())
        if not n_split > 0:
            raise AssertionError('items of 8 faces split no tile')
        for T in (1, 4, 25):
            fv, tex = soup(400, 1, T, SEED + T)
            compare_pxg(f'soup 128 T={T}', fv, tex,
                        make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3))
        fv, tex = soup(400, 1, 3, SEED)
        compare_pxg('soup 64 vertex, background, fill_back off', fv, tex.reshape(1, 400, 3, 3),
                    make_params(image_size=64, texture_type='vertex', fill_back=False,
                                background_color=(0.2, 0.4, 0.6), sigma_val=1e-4,
                                gamma_val=0.1))
        for K in (1, 4, 16):
            compare_pxg(f'soup 128 B=2 K={K}', fv_b2, tex_b2,
                        make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                                    max_faces_per_pixel_for_grad=K))
        # K = 40 is past the per-item lists: the threshold kernel's bisection
        compare_pxg('dense soup 128 K=40, bisection', fv_dense, tex_dense,
                    make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                                max_faces_per_pixel_for_grad=40))
        compare_pxg("soup 24 (tile 8, ragged) grad_mode='full'", fv_b2, tex_b2,
                    make_params(image_size=24, sigma_val=1e-4, gamma_val=1e-3,
                                grad_mode='full'))
        _, _, gf_big = compare_pxg('soup 256 screen-filling faces', fv_big, tex_b2,
                                   make_params(image_size=256, sigma_val=1e-4, gamma_val=1e-3))
        if not gf_big[:, :2].abs().amax() > 0:
            raise AssertionError('the screen-filling faces have no gradient')
        compare_pxg('tie soup 32, hard', tie, textures(4, 1, SEED + 11), p_tie)
    log(f'  items of 8 faces split {n_split} tiles; thresholds equal to the binned route on '
        f'at least {g_same["thr"]:.6f} of pixels in every case, counts on all')

    log('phase 12b: the pxg route at full width, render_mesh and steps at 1024 px, '
        '39,474 faces')
    with route.with_layout('pxg'):
        zero_counts()
        with torch.no_grad():
            for az in azimuths:
                mesh.reset_()
                renderer.transform.set_eyes_from_angles(2.732, 30, az)
                alpha, rgb = renderer.render_mesh(mesh, mode=None)
                if not (torch.isfinite(alpha).all() and alpha.gt(0.5).float().mean() > 0.05):
                    raise AssertionError(f'pxg frame azimuth {az}: non-finite or empty')
        torch.cuda.synchronize()
        want_frames = {'softras_pxg_fwd': FRAMES, 'softras_pxg_combine': FRAMES,
                       'softras_pxg_thr': 0, 'softras_pxg_bwd': 0}
        if read_pxg() != want_frames or any(read_counts().values()) \
                or any(read_dir().values()) or any(read_tiled().values()) or read_sum():
            raise AssertionError(f'pxg launches of {FRAMES} frames: {read_pxg()}, '
                                 f'{read_counts()}, {read_dir()}')
        frame_pxg = read_pxg()
        # the work items of the bench step's frame
        pin_f = pxg_impl.prep_pxg(fv_full, tex_full, p_full, for_grad=True)
        parts_f, depths_f = pxg_impl.launch_pxg_fwd(pin_f, p_full, True)
        img_g, ag_g, cnt_g = pxg_impl.launch_pxg_combine(pin_f, parts_f, p_full)
        over_f = pxg_impl.overfull_tiles(pin_f, cnt_g, p_full)
        n_items = (pin_f.item_off[1:] - pin_f.item_off[:-1]).long()
        faces_t = (pin_f.tile_off[1:] - pin_f.tile_off[:-1]).long()
        busiest = int(faces_t.argmax().item())
        W_f = pin_f.items.shape[0]
        log(f'  {W_f} work items of at most {pxg_impl.GROUP} faces over '
            f'{int(faces_t.gt(0).sum().item())} covered tiles; {pin_f.entries.numel():,} '
            f'entries; the busiest tile holds {int(faces_t[busiest].item())} faces in '
            f'{int(n_items[busiest].item())} items; {over_f.numel()} overfull tiles at K = '
            f'{p_full.max_faces_id}')
        if not torch.equal(cnt_g, counts_full):
            raise AssertionError('1024 px: counts differ from the binned route\'s')
        img_d, _, _ = cuda_impl.launch(inputs, p_full)
        f_b, _ = beyond(img_g, img_d, TOL, pixel_dim=1)
        check('1024 px image vs binned', f_b)
        fwd_err_g = pixels_vs_plain('pxg frame 1 vs plain', fv_full, tex_full, p_full, img_g)
        g_err['fwd'] = max(g_err['fwd'], fwd_err_g)
        thr_g = pxg_impl.launch_pxg_thr(pin_f, depths_f, cnt_g, p_full)
        same_full = (thr_g == thr_f).float().mean().item()
        check('1024 px threshold vs binned', 1.0 - same_full, 1e-4)

        def pxg_steps(tag, step):
            zero_counts()
            for i in range(STEPS):
                step(i)
                want = {n: i + 1 for n in pxg_wrappers}
                if not over_f.numel():
                    want['softras_pxg_thr'] = 0
                if read_pxg() != want or any(read_counts().values()) \
                        or any(read_dir().values()) or any(read_tiled().values()) \
                        or read_sum() != i + 1:
                    raise AssertionError(f'pxg {tag}: launches after step {i + 1}: '
                                         f'{read_pxg()}, {read_counts()}, {read_dir()}, face '
                                         f'sums {read_sum()}')
            torch.cuda.synchronize()
            return {**read_pxg(), 'segment_sum': read_sum()}

        pxg_counts = pxg_steps('soft_rasterize', lambda i: bench_step())
        for name, g in (('face_vertices', fv_leaf.grad), ('textures', tex_leaf.grad)):
            if not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'pxg gradient of {name}: non-finite or zero')
        pxg_mesh_counts = pxg_steps('render_mesh', render_step)
        for name, g in (('mesh.vertices', v_leaf.grad), ('mesh.textures', t_leaf.grad)):
            if g is None or not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'pxg gradient of {name}: missing, non-finite or zero')
        log(f'  launches: {frame_pxg} for {FRAMES} frames; {pxg_counts} for {STEPS} '
            f'soft_rasterize steps, {pxg_mesh_counts} for {STEPS} render_mesh steps; none '
            f'binned or dir')
        if not over_f.numel():
            # no pixel over K = 16: one step at K = 4 gives the threshold kernel work
            zero_counts()
            fv_leaf.grad = tex_leaf.grad = None
            soft_rasterize(fv_leaf, tex_leaf, image_size=1024, sigma_val=1e-5, gamma_val=1e-4,
                           max_faces_per_pixel_for_grad=4).sum().backward()
            torch.cuda.synchronize()
            if read_pxg()['softras_pxg_thr'] != 1:
                raise AssertionError(f'pxg step at K = 4: {read_pxg()}')
            log(f'  no overfull tile at K = 16; a step at K = 4: {read_pxg()}')
            pxg_counts['softras_pxg_thr'] = read_pxg()['softras_pxg_thr']

        # 4,096 pixels' gradient against the plain backward on those pixels
        pin_t = pxg_impl.prep_pxg(fv_full, tex_sym, p_full, for_grad=True)
        img_t, ag_t, cnt_t, thr_tg = pxg_impl.forward(pin_t, p_full, True)
        f_thr_g = ((thr_px - at(thr_tg[:, None])[..., 0]).abs()
                   > THR_RTOL * thr_px.abs()).float().mean().item()
        check('pxg 1024 px threshold on the sampled pixels', f_thr_g, THR_FRAC)
        gf_g, gt_g = pxg_impl.backward(pin_t, img_t, ag_t, thr_tg, g_img, p_full)
        torch.cuda.synchronize()

        def plain_bwd_pxg():
            return torch_impl.backward_pixels(fv_full, tex_sym, at(img_t), at(ag_t), g_px,
                                              p_full, xk, yk, thr=thr_px, chunk_pairs=1 << 22)

        gf_w2, gt_w2 = plain_bwd_pxg()
        f_f, e_f = grad_beyond(gf_g, gf_w2)
        f_t, e_t = grad_beyond(fold_ties(gt_g), fold_ties(gt_w2))
        check('pxg 1024 px face gradient of the sampled pixels', f_f, GRAD_FRAC)
        check('pxg 1024 px texture gradient of the sampled pixels', f_t, GRAD_FRAC)
        g_err['bwd'] = max(g_err['bwd'], e_f, e_t)
        log(f'  gradient of {some} vs plain: face grad {f_f:.6f} beyond (max {e_f:.2g} of '
            f'scale), texture grad {f_t:.6f} (max {e_t:.2g}); threshold {f_thr_g:.6f}; '
            f'threshold map {same_full:.6f} equal to the binned one')

        # each kernel alone on the bench step's inputs, and its plain version
        thr_g = pxg_impl.launch_pxg_thr(pin_f, depths_f, cnt_g, p_full)
        grows_f = pxg_impl.launch_pxg_bwd(pin_f, img_g, ag_g, thr_g, g_ones, p_full)
        gm = {
            'prep': timed(lambda: pxg_impl.prep_pxg(fv_full, tex_full, p_full, for_grad=True),
                          reps=5),
            'fwd': timed(lambda: pxg_impl.launch_pxg_fwd(pin_f, p_full, True), reps=30),
            'fwd_nothr': timed(lambda: pxg_impl.launch_pxg_fwd(pin_f, p_full, False), reps=30),
            'combine': timed(lambda: pxg_impl.launch_pxg_combine(pin_f, parts_f, p_full), reps=30),
            'thr': timed(lambda: pxg_impl.launch_pxg_thr(pin_f, depths_f, cnt_g, p_full), reps=30),
            'bwd': timed(lambda: pxg_impl.launch_pxg_bwd(pin_f, img_g, ag_g, thr_g, g_ones,
                                                         p_full), reps=30),
            'sum': timed(lambda: tiled.face_sum(pin_f, grows_f, p_full), reps=30)}
        PLAIN_ITEMS = 64
        pin_few = pin_f._replace(items=pin_f.items[:PLAIN_ITEMS])
        gm_plain = {
            'fwd': timed(lambda: pxg_impl.fwd_partials_plain(pin_few, p_full, True,
                                                             chunk_pairs=1 << 24), reps=2, warm=1),
            'combine': timed(lambda: pxg_impl.combine_plain(pin_f, parts_f, p_full), reps=2,
                             warm=1),
            'thr': timed(lambda: pxg_impl.thr_plain(pin_f, depths_f, cnt_g, p_full), reps=2,
                         warm=1),
            'bwd': timed(plain_bwd_pxg, reps=2, warm=1),
            'sum': timed(lambda: tiled.sum_plain(pin_f, grows_f, p_full), reps=2, warm=1)}
        gm_on = {'fwd': f'{PLAIN_ITEMS} of {W_f} items', 'combine': 'the whole frame',
                 'thr': 'the whole frame', 'bwd': some, 'sum': 'all rows'}
        # one PyTorch call for the combine's sums and for the face sum:
        # index_add_ of the rows by tile, and by face
        item_tile = pin_f.items[:, 0].long()
        dump_t = torch.zeros((int(pin_f.item_off.numel()) - 1, pxg_impl.PARTS * pxg_impl.PIXELS),
                             device=dev)
        parts_rows = parts_f.reshape(W_f, -1)
        gm_lib = {'combine': timed(lambda: dump_t.zero_().index_add_(0, item_tile, parts_rows),
                                   reps=5)}
        n_fe = (pin_f.face_off[1:] - pin_f.face_off[:-1]).long()
        face_key = torch.repeat_interleave(torch.arange(n_fe.numel(), device=dev), n_fe)
        rows_by_face = grows_f[pin_f.face_entries.long()]
        dump_f = torch.zeros((n_fe.numel(), grows_f.shape[1]), device=dev)
        gm_lib['sum'] = timed(lambda: dump_f.zero_().index_add_(0, face_key, rows_by_face), reps=5)

        # the least time for the same work, from this frame's pair counts
        E_f = pin_f.entries.numel()
        item_bytes = 4 * (E_f + pin_f.items.numel() + pin_f.item_off.numel())
        part_bytes = 4 * W_f * pxg_impl.PARTS * pxg_impl.PIXELS
        list_bytes = 4 * W_f * p_full.max_faces_id * pxg_impl.PIXELS
        over_items = int(n_items[over_f.long()].sum().item())
        over_px = int((cnt_g > p_full.max_faces_id).sum().item())
        gb = {
            # the pair work of the binned forward, and the partial rows and
            # depth lists out
            'fwd': bound(census['tile_list'] * OPS_BBOX + census['in_bbox'] * OPS_DIST
                         + census['inside'] * OPS_INSIDE
                         + census['candidates'] * (OPS_SHADE + OPS_LIST),
                         4 * inputs.rows.numel() + item_bytes + part_bytes + list_bytes),
            # a merge step per (item, pixel); the partial rows in, the image,
            # aggregates and counts out
            'combine': bound(W_f * pxg_impl.PIXELS * OPS_COMBINE,
                             part_bytes + 4 * pin_f.item_off.numel() + 4 * B * 7 * HW),
            # a compare per list entry of the overfull tiles' items; those
            # lists and the counts of their pixels in, their thresholds out
            'thr': bound(over_items * p_full.max_faces_id * pxg_impl.PIXELS * OPS_LIST,
                         4 * over_items * p_full.max_faces_id * pxg_impl.PIXELS
                         + 4 * 2 * over_f.numel() * pxg_impl.PIXELS),
            # the function that the backward and its sum compute together
            'bwd': bound(census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE
                         + census['candidates'] * OPS_DEPTH + census['within_thr'] * OPS_GRAD
                         + E_f * GC,
                         4 * inputs.rows.numel() + item_bytes + 4 * 11 * census['drawn']
                         + 4 * B * F * GC),
            # the entry rows and the face index in, the gradients out
            'sum': bound(E_f * GC, 4 * E_f * GC + 4 * (pin_f.face_off.numel() + E_f)
                         + 4 * B * F * GC)}
        for name in ('fwd', 'combine', 'thr', 'bwd', 'sum'):
            b = gb[name]
            log(f'  bound softras_pxg_{name}: {b[0]:.6f} ms by {b[1]}: {b[2]}')
        log(f'  overfull: {over_f.numel()} tiles, {over_items} items, {over_px} pixels over K')
        log(f'  kernels alone, ms: prep {gm["prep"]:.4f}, partials {gm["fwd"]:.4f} (without '
            f'the depth lists {gm["fwd_nothr"]:.4f}), combine {gm["combine"]:.4f}, threshold '
            f'{gm["thr"]:.4f}, backward {gm["bwd"]:.4f}, sum {gm["sum"]:.4f}  [{smi}]')
        log(f'  plain versions, ms: ' + ', '.join(f'{k} {v:.3f} on {gm_on[k]}'
                                                  for k, v in gm_plain.items())
            + f'; index_add_: combine {gm_lib["combine"]:.4f}, sum {gm_lib["sum"]:.4f}  [{smi}]')
        mem = {'parts': part_bytes, 'depth lists': list_bytes, 'entry rows': 4 * E_f * GC}
        log(f'  scratch, bytes: {mem}')

    # the steps and frames on both routes in turns: binned, pxg, pxg, binned
    g_times = {'binned': [], 'pxg': []}
    for r_name in ('binned', 'pxg', 'pxg', 'binned'):
        with route.with_layout('pxg' if r_name == 'pxg' else 'pxt'):
            t_r = timed(bench_step, reps=STEPS)
            t0 = time.perf_counter()
            for i in range(STEPS):
                render_step(i)
            torch.cuda.synchronize()
            t_m = (time.perf_counter() - t0) * 1e3 / STEPS
            t0 = time.perf_counter()
            with torch.no_grad():
                for i in range(FRAMES):
                    mesh.reset_()
                    renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i])
                    renderer.render_mesh(mesh, mode='rgb')
            torch.cuda.synchronize()
            g_times[r_name].append((t_r, t_m, (time.perf_counter() - t0) * 1e3 / FRAMES))
    g_med = {r: [float(np.median([t[k] for t in ts])) for k in range(3)]
             for r, ts in g_times.items()}
    log(f'  in turns (binned, pxg, pxg, binned), ms: soft_rasterize step / render_mesh step / '
        f'render_mesh frame: {g_times}; medians binned {g_med["binned"]}, pxg {g_med["pxg"]}'
        f'  [{smi}]')

    log('phase 12c: demo 2 on the pxg route, 120 views at 64 px, 1,300 faces')
    with route.with_layout('pxg'):
        model_g = deform.DeformModel(v_s, f_s).to(dev)
        grad_pxg = first_grad(model_g)
        f_g2, e_g2 = grad_beyond(grad_pxg, grad_binned)
        check('demo 2 first gradient on the pxg route vs the binned route', f_g2, GRAD_FRAC)
        optimizer_g = torch.optim.Adam(model_g.parameters(), lr=0.01, betas=(0.5, 0.99))
        zero_counts()
        losses_g, t_pxg = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, sil = deform.deform_step(model_g, optimizer_g, trainer, targets)
            torch.cuda.synchronize()
            t_pxg.append((time.perf_counter() - t0) * 1e3)
            losses_g.append(loss.item())
        train_pxg = read_pxg()
        want = dict.fromkeys(pxg_wrappers, TRAIN_STEPS)
        want['softras_pxg_thr'] = train_pxg['softras_pxg_thr']     # only with an overfull tile
        if train_pxg != want or train_pxg['softras_pxg_thr'] > TRAIN_STEPS \
                or any(read_counts().values()) or any(read_dir().values()) \
                or any(read_tiled().values()) or read_sum() != TRAIN_STEPS:
            raise AssertionError(f'pxg launches of {TRAIN_STEPS} training steps: {train_pxg}, '
                                 f'{read_counts()}, {read_dir()}, face sums {read_sum()}')
        if not (np.isfinite(losses_g).all() and losses_g[-1] < losses_g[0]):
            raise AssertionError(f'the training loss on the pxg route did not fall: {losses_g}')
    log(f'  first gradient vs the binned route: {f_g2:.6f} of entries beyond (max {e_g2:.2g} '
        f'of scale); launches {train_pxg} for {TRAIN_STEPS} steps; loss {losses_g[0]:.6f} -> '
        f'{losses_g[-1]:.6f}; step {np.median(t_pxg[2:]):.3f} ms on the pxg route, '
        f'{np.median(t_train[2:]):.3f} ms binned (phase 7; medians, host clock)  [{smi}]')

    # ---- 13./14. the f_px and px_f routes (JR_LAYOUT) ---------------------
    t_err = dict.fromkeys(['fpx_fwd', 'fpx_bwd', 'pxf_fwd', 'pxf_bwd'], 0.0)
    t_same = {'thr': 1.0}

    def grad_check(tag, got, want, exact, binned):
        """A gradient against the binned route's and the plain version's,
        all but GRAD_FRAC of the entries within the tolerance; against the
        plain version an entry is not counted where the plain version in
        float64 (``exact``) shows the float32 plain version itself to be off
        by at least a quarter of the difference, a knife-edge pixel
        (``checks.grad_unexplained``).  Returns (share beyond the plain one
        and unexplained, share beyond it in all, the max error over the
        scale, share beyond the binned one)."""
        f_w, _ = grad_unexplained(got, want, exact)
        f_all, e_w = grad_beyond(got, want)
        f_k, _ = grad_beyond(got, binned)
        check(tag, f_w, GRAD_FRAC)
        check(f'{tag} vs binned', f_k, GRAD_FRAC)
        return f_w, f_all, e_w, f_k

    def compare_tiled(name, tag, fv, tex, p):
        """The f_px ('fpx') or px_f ('pxf') kernels against their plain
        versions and against the binned route on the same inputs, whole
        image; the backward twice."""
        surface = p.texture_type == 'surface'
        if surface:
            tex = tie_symmetric(tex)
        with_thr = name == 'pxf' and torch_impl.use_threshold(p, fv.shape[1])
        if name == 'fpx':
            if torch_impl.use_threshold(p, fv.shape[1]):
                raise AssertionError(f'{tag}: the f_px backward is untruncated')
            pin = fpx_impl.prep_fpx(fv, tex, p, for_grad=True)
            img, ag, cnt, thr = fpx_impl.launch_fpx_fwd(pin, p)
        else:
            pin = pxf_impl.prep_pxf(fv, tex, p, for_grad=True)
            img, ag, cnt, thr = pxf_impl.launch_pxf_fwd(pin, p, with_thr)
        want, ag_w, cnt_w, thr_w = tiled.fwd_plain(pin, p, with_thr)
        torch.cuda.synchronize()
        f_rgb, e_rgb = beyond(img[:, :3], want[:, :3], TOL, pixel_dim=1)
        f_a, e_a = beyond(img[:, 3], want[:, 3], TOL)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        check(f'{tag} count', beyond(cnt.float(), cnt_w.float(), 0)[0])
        if p.aggr_func_rgb == 'hard':
            check(f'{tag} face index', beyond(ag[:, 1], ag_w[:, 1], 0)[0])
        if not torch.isfinite(img).all():
            raise AssertionError(f'{tag}: non-finite output')
        msg = (f'  {tag}: {pin.tile_h}x{pin.tile_w} tiles, {pin.items.shape[0]} items; rgb '
               f'{f_rgb:.4f} beyond (max {e_rgb:.3g}), alpha {f_a:.4f}')
        e_thr = 0.0
        inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
        b_img, b_ag, b_cnt = cuda_impl.launch(inputs, p)
        b_thr = cuda_impl.topk_threshold(fv, p, inputs, b_cnt)
        if not torch.equal(cnt, b_cnt):
            raise AssertionError(f'{tag}: counts differ from the binned route\'s')
        if with_thr:
            bad = (thr - thr_w).abs() > THR_RTOL * thr_w.abs()
            check(f'{tag} threshold', bad.float().mean().item(), THR_FRAC)
            if not (thr[cnt <= p.max_faces_id] == p.far).all():
                raise AssertionError(f'{tag}: a pixel with at most K candidates has a threshold')
            e_thr = (thr - thr_w).abs().max().item()
            same_thr = (b_thr == thr).float().mean().item()
            t_same['thr'] = min(t_same['thr'], same_thr)
            check(f'{tag} threshold vs binned', 1.0 - same_thr, 1e-4)
            msg += (f', thr {bad.float().mean().item():.6f} beyond, {same_thr:.6f} equal to '
                    f'binned')
        f_b, _ = beyond(img, b_img, TOL, pixel_dim=1)
        check(f'{tag} image vs binned', f_b)
        msg += f'; vs binned: counts equal, image {f_b:.4f} beyond'
        gen.manual_seed(SEED + 3)
        g = torch.randn(img.shape, generator=gen, device=dev)
        impl = fpx_impl if name == 'fpx' else pxf_impl
        bwd = fpx_impl.launch_fpx_bwd if name == 'fpx' else pxf_impl.launch_pxf_bwd
        grows = bwd(pin, img, ag, thr, g, p)
        gf, gt = tiled.face_sum(pin, grows, p)
        gf2, gt2 = impl.backward(pin, img, ag, thr, g, p)
        torch.cuda.synchronize()
        if not (torch.equal(gf, gf2) and torch.equal(gt, gt2)):
            raise AssertionError(f'{tag}: two runs of the backward differ in their bits')
        sf_, st_ = tiled.sum_plain(pin, grows, p)
        (f_sf, e_sf), (f_st, e_st) = grad_beyond(gf, sf_), grad_beyond(gt, st_)
        check(f'{tag} face sum', max(f_sf, f_st), 0.0)
        wf, wt = torch_impl.soft_rasterize_bwd_plain(fv, tex, img, ag, thr_w, g, p,
                                                     chunk_pairs=1 << 22)
        # the plain version in float64, its own forward and threshold: the
        # witness for knife-edge entries
        fv64, tex64 = fv.double(), tex.double()
        img64, ag64, _ = torch_impl.soft_rasterize_fwd_plain(fv64, tex64, p, chunk_pairs=1 << 22)
        thr64 = torch_impl.topk_threshold_plain(fv64, p, chunk_pairs=1 << 22) \
            if with_thr else None
        xf, xt = torch_impl.soft_rasterize_bwd_plain(fv64, tex64, img64, ag64, thr64,
                                                     g.double(), p, chunk_pairs=1 << 22)
        kf, kt = cuda_impl.soft_rasterize_bwd(fv, tex, b_img, b_ag, b_thr, g, p, inputs)
        wt, xt, kt = wt.reshape(gt.shape), xt.reshape(gt.shape), kt.reshape(gt.shape)
        if surface:
            gt, wt, xt, kt = fold_ties(gt), fold_ties(wt), fold_ties(xt), fold_ties(kt)
        f_f, a_f, e_f, k_f = grad_check(f'{tag} face gradient', gf, wf, xf, kf)
        f_t, a_t, e_t, k_t = grad_check(f'{tag} texture gradient', gt, wt, xt, kt)
        moves = p.aggr_func_rgb == 'softmax' or (p.dist_func != 'hard'
                                                  and p.aggr_func_alpha != 'hard')
        if moves and not gf.abs().max() > 0:
            raise AssertionError(f'{tag}: zero face gradient')
        for k, e in (('fwd', max(e_rgb, e_a, e_thr)), ('bwd', max(e_f, e_t))):
            t_err[f'{name}_{k}'] = max(t_err[f'{name}_{k}'], e)
        g_err['sum'] = max(g_err['sum'], e_sf, e_st)
        log(msg + f'; face grad {a_f:.6f} beyond, {f_f:.6f} not the plain version\'s '
            f'rounding (max {e_f:.2g} of scale), texture grad {a_t:.6f} / {f_t:.6f} (max '
            f'{e_t:.2g}); vs binned '
            f'{k_f:.6f} / {k_t:.6f}; sum max {max(e_sf, e_st):.2g}; bit-equal twice')
        return gf

    def sweep(name, sizes, **kw):
        """Phase 11a's configurations on the route, with ``kw`` added."""
        for dist, rgb, alpha in configs:
            p = make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                            aggr_func_alpha=alpha, sigma_val=1e-4, gamma_val=1e-3, **kw)
            compare_tiled(name, f'sphere 128 {dist}/{rgb}/{alpha}', fv_mid, tex_mid, p)
        for size in sizes:
            compare_tiled(name, f'sphere {size} renderer defaults', fv_mid, tex_mid,
                          make_params(image_size=size, **kw))
        for T in (1, 4, 25):
            fv, tex = soup(400, 1, T, SEED + T)
            compare_tiled(name, f'soup 128 T={T}', fv, tex,
                          make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3, **kw))
        fv, tex = soup(400, 1, 3, SEED)
        compare_tiled(name, 'soup 64 vertex, background, fill_back off', fv,
                      tex.reshape(1, 400, 3, 3),
                      make_params(image_size=64, texture_type='vertex', fill_back=False,
                                  background_color=(0.2, 0.4, 0.6), sigma_val=1e-4,
                                  gamma_val=0.1, **kw))
        gf_b = compare_tiled(name, 'soup 256 screen-filling faces, B=2', fv_big, tex_b2,
                                make_params(image_size=256, sigma_val=1e-4, gamma_val=1e-3,
                                            **kw))
        if not gf_b[:, :2].abs().amax() > 0:
            raise AssertionError('the screen-filling faces have no gradient')
        compare_tiled(name, 'tie soup 32, hard', tie, textures(4, 1, SEED + 11), p_tie)

    log("phase 13a: f_px kernels vs plain and vs the binned route, whole images, "
        "grad_mode='full'")
    with route.with_layout('f_px'):
        sweep('fpx', (32, 48, 64, 96, 128, 256), grad_mode='full')
        # a binding truncation takes the binned route: K = 16 < F
        zero_counts()
        x_b = fv_mid.clone().requires_grad_(True)
        soft_rasterize(x_b, tex_mid, image_size=128, sigma_val=1e-4).sum().backward()
        torch.cuda.synchronize()
        if any(read_tiled().values()) or read_sum() \
                or read_counts() != dict.fromkeys(wrappers, 1):
            raise AssertionError(f'f_px layout, binding K = 16: {read_tiled()}, {read_counts()}, '
                                 f'face sums {read_sum()}')
    log('  a binding K = 16 step under JR_LAYOUT=f_px: one launch of each binned wrapper, '
        'none of f_px')

    log("phase 13b: the f_px route at full width, render_mesh frames and grad_mode='full' "
        "steps at 1024 px, 39,474 faces")
    p_full_f = make_params(image_size=1024, grad_mode='full')
    census_f = pair_census(fv_full, p_full_f, cl, counts_full)

    def full_step(i=0):
        fv_leaf.grad = tex_leaf.grad = None
        soft_rasterize(fv_leaf, tex_leaf, image_size=1024, sigma_val=1e-5, gamma_val=1e-4,
                       grad_mode='full').sum().backward()

    fpx_names = ('softras_fpx_fwd', 'softras_fpx_bwd')
    pxf_names = ('softras_pxf_fwd', 'softras_pxf_bwd')

    def only_tiled(tag, want, sums=0):
        """The tiled wrappers' counts are ``want`` (zero where unnamed), the
        face sum's ``sums``, and no other route's wrapper ran."""
        full = dict.fromkeys(tiled_wrappers, 0)
        full.update(want)
        if read_tiled() != full or any(read_counts().values()) or any(read_dir().values()) \
                or any(read_pxg().values()) or read_sum() != sums:
            raise AssertionError(f'{tag}: launches {read_tiled()}, {read_counts()}, '
                                 f'{read_dir()}, {read_pxg()}, face sums {read_sum()}')

    def tiled_frames(tag):
        zero_counts()
        with torch.no_grad():
            for az in azimuths:
                mesh.reset_()
                renderer.transform.set_eyes_from_angles(2.732, 30, az)
                alpha, rgb = renderer.render_mesh(mesh, mode=None)
                if not (torch.isfinite(alpha).all() and alpha.gt(0.5).float().mean() > 0.05):
                    raise AssertionError(f'{tag} frame azimuth {az}: non-finite or empty')
        torch.cuda.synchronize()

    def tiled_steps(tag, step, names):
        zero_counts()
        for i in range(STEPS):
            step(i)
            only_tiled(f'{tag} step {i + 1}', dict.fromkeys(names, i + 1), i + 1)
        torch.cuda.synchronize()
        return {**{n: read_tiled()[n] for n in names}, 'segment_sum': read_sum()}

    with route.with_layout('f_px'):
        tiled_frames('f_px')
        only_tiled(f'f_px {FRAMES} frames', {'softras_fpx_fwd': FRAMES})
        frame_fpx = {**{n: read_tiled()[n] for n in fpx_names}, 'segment_sum': read_sum()}
        fpx_counts = tiled_steps("f_px grad_mode='full' soft_rasterize", full_step, fpx_names)
        for nm, g in (('face_vertices', fv_leaf.grad), ('textures', tex_leaf.grad)):
            if not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'f_px gradient of {nm}: non-finite or zero')
        zero_counts()
        bench_step()
        torch.cuda.synchronize()
        if any(read_tiled().values()) or read_sum() \
                or read_counts() != dict.fromkeys(wrappers, 1):
            raise AssertionError(f'f_px layout, binding K = 16 at 1024 px: {read_tiled()}, '
                                 f'{read_counts()}, face sums {read_sum()}')
        log(f'  launches: {frame_fpx} for {FRAMES} frames; {fpx_counts} for {STEPS} '
            f"grad_mode='full' soft_rasterize steps; a binding K = 16 step: {read_counts()}, "
            f'none of f_px')
        pin_x = fpx_impl.prep_fpx(fv_full, tex_full, p_full_f, for_grad=True)
        img_x, ag_x, cnt_x, _ = fpx_impl.launch_fpx_fwd(pin_x, p_full_f)
        if not torch.equal(cnt_x, counts_full):
            raise AssertionError('f_px 1024 px: counts differ from the binned route\'s')
        img_d, _, _ = cuda_impl.launch(inputs, p_full)
        check('f_px 1024 px image vs binned', beyond(img_x, img_d, TOL, pixel_dim=1)[0])
        t_err['fpx_fwd'] = max(t_err['fpx_fwd'], pixels_vs_plain(
            'f_px frame 1 vs plain', fv_full, tex_full, p_full_f, img_x))
        # the gradient of the 4,096 pixels, untruncated, against the plain backward
        pin_xs = fpx_impl.prep_fpx(fv_full, tex_sym, p_full_f, for_grad=True)
        img_xs, ag_xs, _, _ = fpx_impl.forward(pin_xs, p_full_f)
        gf_x, gt_x = fpx_impl.backward(pin_xs, img_xs, ag_xs, None, g_img, p_full_f)
        torch.cuda.synchronize()

        def plain_bwd_fpx():
            return torch_impl.backward_pixels(fv_full, tex_sym, at(img_xs), at(ag_xs), g_px,
                                              p_full_f, xk, yk, thr=None, chunk_pairs=1 << 22)

        gf_w3, gt_w3 = plain_bwd_fpx()
        f_f, e_f = grad_beyond(gf_x, gf_w3)
        f_t, e_t = grad_beyond(fold_ties(gt_x), fold_ties(gt_w3))
        check('f_px 1024 px face gradient of the sampled pixels', f_f, GRAD_FRAC)
        check('f_px 1024 px texture gradient of the sampled pixels', f_t, GRAD_FRAC)
        t_err['fpx_bwd'] = max(t_err['fpx_bwd'], e_f, e_t)
        log(f'  gradient of {some} vs plain, untruncated: face grad {f_f:.6f} beyond (max '
            f'{e_f:.2g} of scale), texture grad {f_t:.6f} (max {e_t:.2g})')

    def tiled_timing(name, pin_k, p_k, img_k, ag_k, thr_k, census_k, plain_fwd, plain_bwd):
        """Each kernel of the route alone on the full frame's inputs, its plain
        version and, for the face sum, index_add_; the bounds from this
        frame's pair counts.  Returns (ms, plain ms, plain_on, library ms,
        bounds)."""
        impl = fpx_impl if name == 'fpx' else pxf_impl
        if name == 'fpx':
            fwd = lambda: fpx_impl.launch_fpx_fwd(pin_k, p_k)
            bwd = lambda: fpx_impl.launch_fpx_bwd(pin_k, img_k, ag_k, None, g_ones, p_k)
            prep = lambda: fpx_impl.prep_fpx(fv_full, tex_full, p_k, for_grad=True)
        else:
            fwd = lambda: pxf_impl.launch_pxf_fwd(pin_k, p_k, True)
            bwd = lambda: pxf_impl.launch_pxf_bwd(pin_k, img_k, ag_k, thr_k, g_ones, p_k)
            prep = lambda: pxf_impl.prep_pxf(fv_full, tex_full, p_k, for_grad=True)
        summ = lambda: tiled.face_sum(pin_k, grows_k, p_k)
        grows_k = bwd()
        ms = {'prep': timed(prep, reps=5), 'fwd': timed(fwd, reps=30),
              'bwd': timed(bwd, reps=30), 'sum': timed(summ, reps=30)}
        if name == 'pxf':
            ms['fwd_nothr'] = timed(lambda: pxf_impl.launch_pxf_fwd(pin_k, p_k, False), reps=30)
        plain = {'fwd': timed(plain_fwd, reps=2, warm=1), 'bwd': timed(plain_bwd, reps=2, warm=1),
                 'sum': timed(lambda: tiled.sum_plain(pin_k, grows_k, p_k), reps=2, warm=1)}
        on = {'fwd': some, 'bwd': some, 'sum': 'all rows'}
        n_fe = (pin_k.face_off[1:] - pin_k.face_off[:-1]).long()
        key = torch.repeat_interleave(torch.arange(n_fe.numel(), device=dev), n_fe)
        by_face = grows_k[pin_k.face_entries.long()]
        dump = torch.zeros((n_fe.numel(), grows_k.shape[1]), device=dev)
        lib = {'sum': timed(lambda: dump.zero_().index_add_(0, key, by_face), reps=5)}
        E_k, W_k = pin_k.entries.numel(), pin_k.items.shape[0]
        list_bytes = 4 * (E_k + pin_k.tile_off.numel())
        item_bytes = 4 * (E_k + pin_k.items.numel())
        K = p_k.max_faces_id
        thr_ops = census_k['candidates'] * OPS_LIST if name == 'pxf' else 0
        bnd = {
            # the binned forward's pair work, which needs no more than 16 x 16
            # tiles' lists (``tile_list``: the wider f_px tiles' lists test
            # more pairs, a cost of this tiling, not of the function), the
            # candidates (on px_f) compared into the threshold's list; the
            # rows, the lists and the outputs (image 4, aggregates 2, count,
            # threshold)
            'fwd': bound(census_k['tile_list'] * OPS_BBOX + census_k['in_bbox'] * OPS_DIST
                         + census_k['inside'] * OPS_INSIDE
                         + census_k['candidates'] * OPS_SHADE + thr_ops,
                         4 * inputs.rows.numel() + list_bytes
                         + 4 * B * (7 + (name == 'pxf')) * HW),
            # the function that the backward and its face sum compute together
            'bwd': bound(census_k['in_bbox'] * OPS_DIST + census_k['inside'] * OPS_INSIDE
                         + census_k['candidates'] * OPS_DEPTH
                         + census_k['within_thr'] * OPS_GRAD + E_k * GC,
                         4 * inputs.rows.numel() + item_bytes
                         + 4 * (10 + (name == 'pxf')) * census_k['drawn'] + 4 * B * F * GC),
            # the entry rows and the face index in, the gradients out
            'sum': bound(E_k * GC, 4 * E_k * GC + 4 * (pin_k.face_off.numel() + E_k)
                         + 4 * B * F * GC)}
        faces_t = (pin_k.tile_off[1:] - pin_k.tile_off[:-1]).long()
        log(f'  {pin_k.tile_h}x{pin_k.tile_w} tiles: {int(faces_t.gt(0).sum().item())} covered '
            f'of {faces_t.numel()}, {E_k:,} entries, {W_k} work items of at most '
            f'{impl.GROUP} faces, the busiest tile {int(faces_t.max().item())} faces')
        for k in ('fwd', 'bwd', 'sum'):
            log(f'  bound softras_{name}_{k}: {bnd[k][0]:.6f} ms by {bnd[k][1]}: {bnd[k][2]}')
        log(f'  kernels alone, ms: ' + ', '.join(f'{k} {v:.4f}' for k, v in ms.items())
            + f'  [{smi}]')
        log(f'  plain versions, ms: ' + ', '.join(f'{k} {v:.3f} on {on[k]}'
                                                  for k, v in plain.items())
            + f'; index_add_: sum {lib["sum"]:.4f}  [{smi}]')
        return ms, plain, on, lib, bnd

    with route.with_layout('f_px'):
        fpx_t = tiled_timing(
            'fpx', pin_x, p_full_f, img_x, ag_x, None, census_f,
            lambda: torch_impl.forward_pixels(fv_full, tex_full, p_full_f, xk, yk,
                                              chunk_pairs=1 << 24),
            plain_bwd_fpx)

    # ---- 14. the px_f route ------------------------------------------------
    log('phase 14a: px_f kernels vs plain and vs the binned route, whole images')
    with route.with_layout('px_f'):
        sweep('pxf', (24, 40, 48, 64, 96, 120, 256))
        for K in (1, 4, 16):
            compare_tiled('pxf', f'soup 128 B=2 K={K}', fv_b2, tex_b2,
                          make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                                      max_faces_per_pixel_for_grad=K))
        # K = 40 is past the per-pixel lists: the forward's bisection
        compare_tiled('pxf', 'dense soup 128 K=40, bisection', fv_dense, tex_dense,
                      make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3,
                                  max_faces_per_pixel_for_grad=40))
        compare_tiled('pxf', "soup 24 (tile 8) grad_mode='full'", fv_b2, tex_b2,
                      make_params(image_size=24, sigma_val=1e-4, gamma_val=1e-3,
                                  grad_mode='full'))
    log(f'  thresholds equal to the binned route on at least {t_same["thr"]:.6f} of pixels in '
        f'every case, counts on all')

    # bands: 256 px in 4 contiguous bands of tile rows, K = 16 and K = 40
    for tag_b, fv, tex, kw in (('sphere 256 K=16', fv_mid, tex_mid, {}),
                               ('dense soup 256 K=40', fv_dense, tex_dense,
                                dict(sigma_val=1e-4, gamma_val=1e-3,
                                     max_faces_per_pixel_for_grad=40)),
                               ('soup 256 B=2 K=4', fv_big, tex_b2,
                                dict(sigma_val=1e-4, gamma_val=1e-3,
                                     max_faces_per_pixel_for_grad=4))):
        p_b = make_params(image_size=256, **kw)
        tex = tie_symmetric(tex)
        whole = pxf_impl.prep_pxf(fv, tex, p_b, for_grad=True)
        outs_w = pxf_impl.launch_pxf_fwd(whole, p_b, True)
        gen.manual_seed(SEED + 14)
        g_b = torch.randn(outs_w[0].shape, generator=gen, device=dev)
        gf_w, gt_w = pxf_impl.backward(whole, outs_w[0], outs_w[1], outs_w[3], g_b, p_b)
        rows_b = whole.tiles_y // 4
        parts, sf_b, st_b = [], torch.zeros_like(gf_w), torch.zeros_like(gt_w)
        for k in range(4):
            pin_b = pxf_impl.prep_pxf(fv, tex, p_b, ty0=k * rows_b, ty_band=rows_b,
                                      for_grad=True)
            out_b = pxf_impl.launch_pxf_fwd(pin_b, p_b, True)
            parts.append(out_b)
            sl = slice(k * rows_b * whole.tile_h, (k + 1) * rows_b * whole.tile_h)
            bf, bt = pxf_impl.backward(pin_b, out_b[0], out_b[1], out_b[3],
                                       g_b[:, :, sl].contiguous(), p_b)
            sf_b += bf
            st_b += bt
        torch.cuda.synchronize()
        for i, full in enumerate(outs_w):
            if not torch.equal(torch.cat([o[i] for o in parts], dim=-2), full):
                raise AssertionError(f'bands {tag_b}: output {i} of the 4 bands differs from '
                                     f'the whole image\'s')
        (f_bf, e_bf), (f_bt, e_bt) = grad_beyond(sf_b, gf_w), grad_beyond(
            fold_ties(st_b), fold_ties(gt_w))
        check(f'bands {tag_b} face gradient', f_bf, 0.0)
        check(f'bands {tag_b} texture gradient', f_bt, 0.0)
        log(f'  bands {tag_b}: 4 bands of {rows_b} tile rows (ty0 = 0, {rows_b}, {2 * rows_b}, '
            f'{3 * rows_b}): image, aggregates, counts and thresholds equal to the whole '
            f'image\'s to the bit; gradients summed over the bands within max {e_bf:.2g} / '
            f'{e_bt:.2g} of scale of the whole')

    log('phase 14b: the px_f route at full width, render_mesh frames and steps at 1024 px, '
        '39,474 faces, K = 16')
    with route.with_layout('px_f'):
        tiled_frames('px_f')
        only_tiled(f'px_f {FRAMES} frames', {'softras_pxf_fwd': FRAMES})
        frame_pxf = {**{n: read_tiled()[n] for n in pxf_names}, 'segment_sum': read_sum()}
        pxf_counts = tiled_steps('px_f soft_rasterize', lambda i: bench_step(), pxf_names)
        for nm, g in (('face_vertices', fv_leaf.grad), ('textures', tex_leaf.grad)):
            if not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'px_f gradient of {nm}: non-finite or zero')
        pxf_mesh_counts = tiled_steps('px_f render_mesh', render_step, pxf_names)
        for nm, g in (('mesh.vertices', v_leaf.grad), ('mesh.textures', t_leaf.grad)):
            if g is None or not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f'px_f gradient of {nm}: missing, non-finite or zero')
        log(f'  launches: {frame_pxf} for {FRAMES} frames; {pxf_counts} for {STEPS} '
            f'soft_rasterize steps, {pxf_mesh_counts} for {STEPS} render_mesh steps; none '
            f'binned, dir or pxg')
        pin_p = pxf_impl.prep_pxf(fv_full, tex_full, p_full, for_grad=True)
        img_p, ag_p, cnt_p, thr_p = pxf_impl.launch_pxf_fwd(pin_p, p_full, True)
        if not torch.equal(cnt_p, counts_full):
            raise AssertionError('px_f 1024 px: counts differ from the binned route\'s')
        same_p = (thr_p == thr_f).float().mean().item()
        check('px_f 1024 px threshold vs binned', 1.0 - same_p, 1e-4)
        img_d, _, _ = cuda_impl.launch(inputs, p_full)
        check('px_f 1024 px image vs binned', beyond(img_p, img_d, TOL, pixel_dim=1)[0])
        t_err['pxf_fwd'] = max(t_err['pxf_fwd'], pixels_vs_plain(
            'px_f frame 1 vs plain', fv_full, tex_full, p_full, img_p))
        pin_ps = pxf_impl.prep_pxf(fv_full, tex_sym, p_full, for_grad=True)
        img_ps, ag_ps, _, thr_ps = pxf_impl.forward(pin_ps, p_full, True)
        f_thr_p = ((thr_px - at(thr_ps[:, None])[..., 0]).abs()
                   > THR_RTOL * thr_px.abs()).float().mean().item()
        check('px_f 1024 px threshold on the sampled pixels', f_thr_p, THR_FRAC)
        gf_p, gt_p = pxf_impl.backward(pin_ps, img_ps, ag_ps, thr_ps, g_img, p_full)
        torch.cuda.synchronize()

        def plain_bwd_pxf():
            return torch_impl.backward_pixels(fv_full, tex_sym, at(img_ps), at(ag_ps), g_px,
                                              p_full, xk, yk, thr=thr_px, chunk_pairs=1 << 22)

        gf_w4, gt_w4 = plain_bwd_pxf()
        f_f, e_f = grad_beyond(gf_p, gf_w4)
        f_t, e_t = grad_beyond(fold_ties(gt_p), fold_ties(gt_w4))
        check('px_f 1024 px face gradient of the sampled pixels', f_f, GRAD_FRAC)
        check('px_f 1024 px texture gradient of the sampled pixels', f_t, GRAD_FRAC)
        t_err['pxf_bwd'] = max(t_err['pxf_bwd'], e_f, e_t)
        log(f'  gradient of {some} vs plain: face grad {f_f:.6f} beyond (max {e_f:.2g} of '
            f'scale), texture grad {f_t:.6f} (max {e_t:.2g}); threshold {f_thr_p:.6f}; '
            f'threshold map {same_p:.6f} equal to the binned one')
        pxf_t = tiled_timing(
            'pxf', pin_p, p_full, img_p, ag_p, thr_p, census, lambda: torch_impl.forward_pixels(
                fv_full, tex_full, p_full, xk, yk, chunk_pairs=1 << 24), plain_bwd_pxf)

    # the steps and frames on both routes in turns: binned, px_f, px_f, binned
    p_times = {'binned': [], 'px_f': []}
    for r_name in ('binned', 'px_f', 'px_f', 'binned'):
        with route.with_layout(r_name if r_name == 'px_f' else 'pxt'):
            t_r = timed(bench_step, reps=STEPS)
            t0 = time.perf_counter()
            for i in range(STEPS):
                render_step(i)
            torch.cuda.synchronize()
            t_m = (time.perf_counter() - t0) * 1e3 / STEPS
            t0 = time.perf_counter()
            with torch.no_grad():
                for i in range(FRAMES):
                    mesh.reset_()
                    renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[i])
                    renderer.render_mesh(mesh, mode='rgb')
            torch.cuda.synchronize()
            p_times[r_name].append((t_r, t_m, (time.perf_counter() - t0) * 1e3 / FRAMES))
    p_med = {r: [float(np.median([t[k] for t in ts])) for k in range(3)]
             for r, ts in p_times.items()}
    log(f'  in turns (binned, px_f, px_f, binned), ms: soft_rasterize step / render_mesh step / '
        f'render_mesh frame: {p_times}; medians binned {p_med["binned"]}, px_f '
        f'{p_med["px_f"]}  [{smi}]')

    # ---- 15. results ----------------------------------------------------
    launches = {**step_counts, **n_step_counts, **dir_counts, **pxg_counts, **fpx_counts,
                **pxf_counts}
    # the face sum ran in the pxg, f_px and px_f steps alike
    launches['segment_sum'] = sum(c['segment_sum'] for c in (pxg_counts, fpx_counts,
                                                              pxf_counts))

    def entry(name, source, replaces, err, ms, plain_ms, plain_on, b, library_ms=None):
        return {'name': name, 'route': 'cuda',
                'source': f'jrender_tpu_torch/csrc/{source}', 'replaces': replaces,
                'launches': launches[name], 'max_abs_err': err, 'ms': ms,
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
        entry('n3mr_maps', 'n3mr_maps.cu', 'jrender_tpu/ops/n3mr/pallas_impl.py:34',
              n_err['n3mr_maps'], maps_ms, maps_plain_ms, f'{SAMPLES} of {HW_n} pixels',
              maps_bound),
        entry('n3mr_texbwd', 'n3mr_texbwd.cu', 'jrender_tpu/ops/n3mr/pallas_impl.py:347',
              n_err['n3mr_texbwd'], texbwd_ms, texbwd_plain_ms, 'the whole frame',
              texbwd_bound, texbwd_lib_ms),
        entry('n3mr_edgebwd', 'n3mr_edgebwd.cu', 'jrender_tpu/ops/n3mr/banded_bwd.py:347',
              n_err['n3mr_edgebwd'], edgebwd_ms, edge_plain_ms,
              f'{ids_n.numel()} of {F_n} faces', edgebwd_bound),
        entry('softras_dir_fwd', 'softras_dir_fwd.cu', 'jrender_tpu/ops/softras/dir_impl.py:202',
              max(d_err['fwd'], small['fwd_err']), small['fwd_ms'],
              small['fwd_plain_ms'], small['plain_on'], small['fwd_bound']),
        entry('softras_dir_bwd', 'softras_dir_bwd.cu', 'jrender_tpu/ops/softras/dir_impl.py:480',
              max(d_err['bwd'], small['bwd_err']), small['bwd_ms'], small['bwd_plain_ms'],
              small['plain_on'], small['bwd_bound']),
        *(entry(f'softras_pxg_{k}', src, rep, g_err[k], gm[k], gm_plain[k], gm_on[k], gb[k],
                gm_lib.get(k))
          for k, src, rep in (
              ('fwd', 'softras_pxg_fwd.cu', 'jrender_tpu/ops/softras/pxg_impl.py:314'),
              ('combine', 'softras_pxg_fwd.cu', 'jrender_tpu/ops/softras/pxg_impl.py:449'),
              ('thr', 'softras_pxg_thr.cu', 'jrender_tpu/ops/softras/pxg_impl.py:545'),
              ('bwd', 'softras_pxg_bwd.cu', 'jrender_tpu/ops/softras/pxg_impl.py:758'))),
        # timed on the pxg step's entry rows (phase 12b); the f_px and px_f
        # steps' rows are timed in phases 13b and 14b
        entry('segment_sum', 'segment_sum.cu', 'jrender_tpu/ops/softras/pxg_impl.py:998',
              g_err['sum'], gm['sum'], gm_plain['sum'], gm_on['sum'], gb['sum'],
              gm_lib['sum']),
        *(entry(f'softras_{r}_{k}', f'softras_{r}_{k}.cu',
                f'jrender_tpu/ops/softras/pallas_impl.py:{line}',
                t_err[f'{r}_{k}'], tm[0][k], tm[1][k], tm[2][k], tm[4][k], tm[3].get(k))
          for r, tm, rows_ in (('fpx', fpx_t, ((313, 'fwd'), (442, 'bwd'))),
                               ('pxf', pxf_t, ((894, 'fwd'), (1161, 'bwd'))))
          for line, k in rows_),
    ]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
