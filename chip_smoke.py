#!/usr/bin/env python3
"""Drive the port's SoftRas (binned, dir, pxg, f_px and px_f routes) and N3MR
mesh paths, its file IO, its scene pipeline, its volume/NeRF stack and its
parallel stack on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc``;
without a card it exits with code 2 and prints no result.  Phases, each
of which raises on failure:

  1. the device: name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source of the package (one nvcc each, in
     parallel) and print the compiler's register and spill report;
  3. every kernel against its plain PyTorch version on whole images:
     the forward at 128 and 256 px over the rasterizer's configurations,
     and the split of a tile's list over the cluster's blocks: lists of many
     chunks a rank over distance x rgb x alpha, big faces spanning ranks,
     lists of one face, twins at equal depth in different ranks (the lower
     id wins), rows past 48 KB of shared memory, counts and winners exact
     there; the top-K threshold over the same meshes, K = 1, 4, 16 and 40
     over the three distances on lists of many chunks a rank, big faces
     spanning ranks, twins (each depth counts twice), lists of one face, a
     ragged edge and the busiest tile's faces alone, each map bit-equal
     twice and at 2, 4 and 8 blocks per tile;
     the backward and its face reduction at 128 px over distance x rgb x
     alpha, texture sizes, vertex colours, batches, a ragged size,
     ``grad_mode='full'``, big faces, rows past 48 KB and runs of many
     chunks a rank, and big faces at B = 2 with T = 1, 4, 9 and 25 (the
     reduction's instances); forward and backward each run twice for bit
     equality, the reduction bit-equal to its plain version;
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
     bounded from this run's pair counts; the forward, threshold and
     backward also on the busiest tile's faces alone and built with 2, 4
     and 8 blocks per tile (the threshold's maps bit-equal across them),
     the threshold also at K = 40 (its bisection);
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
     a face that spans most of the screen, and triangles whose long edges
     take the edge gradient's global list; the edge gradient with rgb,
     alpha and both, its band keys equal to the plain version's; the
     texture gradient's instances at 72 px, B = 2, on the screen-filling,
     zero-area and NaN faces: texture sizes 1, 2 and 4 (sums in registers),
     6, 7 and 9 (in shared memory, one walk and several); each backward run
     twice for bit equality;
  9. the N3MR path at full width: ``Renderer(dr_type='n3mr',
     image_size=1024).render_mesh`` renders 8 frames of the 39,474-face
     sphere with 2x2x2 texels per face (rgb, then silhouettes and depth);
     8 steps of ``rasterize(...).sum().backward()`` (what ``bench.py``'s
     ``n3mr_row`` times), one launch of each wrapper per step; the maps of
     4,096 random pixels, the whole texture gradient and the edge gradient
     of 48 faces are held against the plain versions, and the edge
     gradient on 2,048-px maps (the anti-aliased step's size); two steps
     with anti-aliasing (2048 px inside); every kernel is timed alone and
     bounded from this run's counts, the edge kernels also at 2048 px; the
     band keys at 1024 px equal the plain version's, bit for bit; the
     z-buffer on the busiest tile's cluster alone (a grid of one cluster)
     and every other build of ``n3mr.cuda_impl.MAPS_BUILDS`` twice,
     bit-equal to the default build;
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
        then both kernels alone on phase 4's 39,474-face sphere; on each,
        the backward's work items against their plain rule, the bytes of its
        partial rows, the peak memory of one call, both kernels bit-equal
        twice, and in the steps the backward's wait on the item count;
     c. demo 2's trainer (phase 7's configuration) on the dir route: the
        first step's gradient against phase 7's binned one, 20 steps, the
        loss must fall, the step time beside phase 7's; both kernels alone
        on the first step's inputs, as in b;
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
        each pxg wrapper per step (the threshold's on every step: it runs
        over every tile) and none of the binned or dir ones; the work
        items, the busiest tile's split and the overfull tiles (there must
        be some at K = 16); 4,096 pixels and their gradient against the
        plain versions; each kernel timed alone and bounded from this run's
        counts, the threshold (K8) beside its wrapper, on the overfull tile
        of the most items alone and at K = 40, the partials (K7) and the
        backward (K9) also on the busiest tile's work items alone, K9 also
        at work items of 8 faces (rows bit-equal to the default's), and
        every other build of the three (``pxg_impl.FWD_CAPS``,
        ``BWD_BUILDS``, ``THR_BUILDS``; K8 at K = 16 and 40) twice,
        bit-equal to the default build; the steps and frames on both routes
        in turns;
     c. demo 2's trainer on the pxg route: the first step's gradient against
        phase 7's binned one, 20 steps, the loss must fall;
 13. the f_px route, which ``JR_LAYOUT=f_px`` opens (phases 3-12 run with it
     unset and assert that no f_px or px_f kernel ran):
     a. its forward (K3), untruncated backward (K4) and face sum against
        their plain versions and the binned route on whole images of 32 to
        256 px, phase 11a's sweep, ``grad_mode='full'``; counts equal to the
        binned route's on every pixel; each backward twice, bit-equal; a
        binding K = 16 step takes the binned route; K3 twice, bit-equal,
        against the plain version of its split over a cluster's blocks
        (``tiled.fwd_split_plain``: images within 1e-4, aggregates 1e-3
        relative, counts and winners equal, on all but 1% of the pixels;
        the share beyond 1e-5 read),
        and built with 2 and 4 blocks per tile (counts and winners bit for
        bit, images within 1e-5);
     b. 8 ``render_mesh`` frames (one K3 launch each) and 8
        ``grad_mode='full'`` steps of ``soft_rasterize`` (one launch of K3,
        K4 and the face sum each) at 1024 px on the 39,474-face sphere, none
        of another route; 4,096 pixels and their gradient against the plain
        versions; the whole frame (softmax and hard rgb) against the plain
        version of the split, as in a; each kernel timed alone and bounded,
        K3 also on the busiest tile's faces alone and at 2, 4 and 8 blocks
        per tile, K4 on the busiest tile's faces alone and with vertex
        colours, with its registers, blocks an SM and work items; the step
        on both routes in turns;
 14. the px_f route (``JR_LAYOUT=px_f``):
     a. its forward with the threshold (K5), backward (K6) and face sum
        against their plain versions and the binned route at 24 to 256 px,
        the same sweep, K = 1, 4, 16 and 40 (bisection); counts on every
        pixel and thresholds on 99.99% equal to the binned route's; K5
        against the plain version of its split and its other builds as K3
        in 13a, thresholds too; 256 px in 4 bands of tile rows: the bands
        side by side equal the whole image to the bit and their gradients
        summed the whole gradient;
     b. 8 frames, 8 steps of ``soft_rasterize`` and 8 of ``render_mesh`` at
        1024 px, K = 16, one launch of each px_f wrapper per step; 4,096
        pixels and their gradient against the plain versions; the whole
        frame against the plain version of the split and in 4 bands of tile
        rows (bit for bit); each kernel timed alone and bounded, K5 also on
        the busiest tile alone and at 2, 4 and 8 blocks per tile, K6 as K4
        in 13b; the steps on both routes in turns;
 15. the files and the scene at full width, written from a seed into a
     temporary directory (removed at the end); K1 runs on three new paths:
     a. ``uv_sphere(130, 153)`` (39,474 faces) as an OBJ with vt (the
        sphere's (u, v)) and vn, an MTL naming a seeded 1024 x 1024 RGB
        ``map_Kd`` and a ``map_normal`` bump map, both PNGs of the port's
        codec; the native parser (asserted built) and the Python parser
        give the faces written, to the bit; the image library in use is
        printed (imageio, PIL, else the codec);
     b. demo 1's path: ``Mesh.from_obj(load_texture=True, texture_res=5)``
        on the card, its textures within 1e-6 of the CPU load; 8 frames of
        ``Renderer(image_size=1024).render_mesh`` (per-texel light through
        the normal map), one K1 launch each, 4,096 pixels held as in phase
        4; ``save_obj(save_texture=True)`` with a 32-px atlas tile and a
        load: vertices and faces exact, textures within the atlas's 8 bits;
     c. demo 1.5's path: ``with_SSS=True``, ``texture_res=15``,
        ``normalization=True`` (textures [1, 39474, 225, 3]); 2 frames at
        1024 px, each SSS's three UV maps at 2048 px on K1 (4 launches a
        frame); 4,096 pixels of each map against the plain version; each SSS
        stage timed (light, the three maps, the blur, the resampling); on
        demo 2's 1,300-face sphere the three whole UV maps against the
        plain version, and the SSS textures against the CPU's blur and
        resampling of the same maps, within 1e-4 of max;
     d. a scene OBJ/MTL (a textured floor, a mirror quad lying on it, the
        39,474-face sphere, glossy, and a box) lit by a point light with
        its shadow (PCF), an area light (VSSM), a directional light with
        its shadow (PCF) and an ambient light: ``Render(image_size=1024)``
        with ``ssr_mode`` naive and hiz, Cook-Torrance (mirror and glossy)
        and Blinn-Phong (mirror only: SSSR reads the metallic-roughness
        buffer, which Cook-Torrance alone fills), then SSAO and SSDO; every
        G-buffer and depth map held on 4,096 pixels against the plain
        version (rgb and depth within 1e-4, face ids equal, each on all but
        1% of the pixels); K1 launches per ``deferred_render`` and the
        host-clock ms of each stage (rasterizations, visibility, SSSR, SSR,
        shading and FXAA, SSAO, SSDO); the whole pipeline at 128 px on the
        3,330-face sphere against the port's CPU run on the same draws
        (1e-4, all but 1% of the pixels and of the face ids);
     e. ``Mesh.voxelize`` of the 39,474-face sphere at 32 on the card and
        the CPU (equal grids) and at 128 twice on the card (equal, timed);
 16. volume rendering and NeRF (``jrender_tpu_torch.vol``, ``.nerf``; plain
     PyTorch, no kernel of the package's own, so the package's kernel
     counts stay 0 here), at the lego config's full width: 8 x 256 coarse
     and fine MLPs with view directions, 1,024 rays, 64 + 128 samples;
     TF32 must be off (``allow_tf32`` False, float32 matmul precision
     'highest'):
     a. one batch on the card against the port's CPU path on the same
        weights and fed draws (white_bkgd, perturbed): rgb, acc, rgb0 within
        1e-4 of each one's max, disp within 1e-3 (1 / (depth / acc), the
        worst conditioned), the weight gradients of three layers
        (coarse layer 0, fine layer 5 after the skip, fine views layer)
        within 1e-3 of their max: the card sums its matrix products in
        another order and divides by a Python scalar through its
        reciprocal;
     b. ``bench.py``'s NeRF row on the port: its 400² target and pose,
        10 + 30 + 100 steps of the no-batching train step; ms per step
        (median of 30, CUDA events; and by the host clock), rays a second,
        the bound from the MLP's float32 work, the device time split
        between matrix products and the rest (torch.profiler), launches,
        busy share, peak device memory; the PSNR must rise by more than 3 dB
        (``bench.py``'s ``learned``);
     c. ``render_full_image`` at 400² (chunk 32,768, netchunk 65,536) twice,
        equal to the bit, timed;
     d. ``train(args)`` on a Blender scene written here (3 views a split,
        64 px, 4 x 64 nets, 32 + 32 samples, precrop): 40 steps straight
        with ``--profile_dir`` (the trace must name CUDA kernels) and a
        validation PNG, against 20 steps, a checkpoint and a resume to 40
        (within 1e-6); 20 steps with ``net_precision bf16``, and bf16
        operands against float32 on the trained lego net at the CPU test's
        bound (mean relative 2%);
 17. the parallel stack (``jrender_tpu_torch.parallel``; a world of n
     ranks on one card is emulated in one process, band by band):
     a. bench.py's sphere at 1024 px (39,474 faces, T = 25, K = 16, softmax
        and hard rgb as phase 5), cut into n = 2, 4 and 8 bands of 16-px
        tile rows, strided and contiguous (``parallel.render.band_forward``,
        K1, its threshold, K2 and the reduction on each band): each band's
        image, aggregates, counts and threshold bit-equal to the whole
        image's rows, its slot rows to the whole image's, the bands
        assembled into the image bit for bit, and the bands' gradients
        summed within 1e-5 of the whole image's max; at 128 and 256 px,
        B = 2 with big faces, each band's kernels against the plain
        versions on the band's rows at phase 3's tolerances;
     b. ``soft_rasterize_sharded`` through a one-rank NCCL group (a file
        store) against ``soft_rasterize`` on the same inputs: image and both
        gradients bit-equal, under ``JR_LAYOUT`` pxt (one launch of K1, its
        threshold, K2 and the reduction) and px_f (one of each px_f kernel);
     c. the device time of K1, its threshold and K2 on each band of 4,
        strided against contiguous, with each band's pairs (the load
        balance of render.py:85-91);
     d. ``make_sharded_nerf_step`` at the lego config's widths on
        bench.py's target through the one-rank group: 3 steps bit-equal to
        the unsharded step, two data shares' gradients summed within 1e-4
        of the whole batch's max, ms a step beside phase 16b's;
 18. the Hopper probes of the TPU tools (``jrender_tpu_torch/probes/``),
     off the main path (no package entry point calls them; their counts,
     zeroed before phase 3, are read before phase 18, and are 0):
     a. T1 (``tools/exp_torch_micro.py``, tools/exp_micro.py's cases): the
        eight cases on 838 steps, the products in both builds (tensor cores,
        FFMA), and pair23_face7_slice9 (the chain's unrolled tail); each
        case without products bit-equal to its plain version (the kernel's
        FMAs in its order; the plain version with one pair op fewer must
        give other steps' rows), with products within rtol 1e-5; bit-equal twice;
        the fixed cost of a step and of a pair op, fitted from
        pair20 / pair100 / pair300;
     b. T2 (``tools/exp_torch_bwd_dma.py``, tools/exp_bwd_dma.py's
        variants that trace): base, dma16, dma1r, tr256, dots (three builds)
        on 3,973 items, gout within rtol 1e-5 and the staged bits'
        checksums equal to the plain version's; µs an item, cp.async (16
        rows) against TMA bulk copies (18 rows);
     c. T3 (``tools/profile_torch_bwd.py``, tools/profile_bwd.py's
        stages): the px_f backward by stage on the 288- and 39,474-face
        spheres at 1024 px, K6's rows bit-equal to the px_f step's own K6
        launch and the stages' backward to ``pxf_impl.backward``'s; device
        and host ms, launches and host synchronisations a stage (the tool
        in a process of its own: in this one the profiler's traces lose
        device activity after phases 3-17);
 19. one JSON line of the kernels (22 of them), each with ``ms`` (its
     wrapper, CUDA events around calls) and ``device_ms`` (the kernel's own
     device time per launch in the steps its route's phase runs,
     torch.profiler: jrender_tpu_torch/utils/device_time.py), K1's also
     with its launches on phase 15's paths, K1's, its threshold's and K2's
     with their device time on each band of phase 17c and their launches
     on phase 17b's sharded step, K6's with T3's stage time, the probes'
     with their cases; the last line is the device JSON.

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
threshold its own way (see tests/test_torch_kernels.py).  The reduction's
plain version adds each face's rows in the kernel's order: the two agree
bit for bit.  In the kernels line, ``max_abs_err`` of the backward is a
share of max|grad|, the reduction's is 0; ``plain_on`` says what the plain version's time covers: it
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
output written once.  Beside it the edge kernel's line gives
``band_bytes_ms``: the bytes of the band design (each band's rows of both
views read once, the keys, their order, the items and the slots) at the
HBM rate; ``n3mr_edge_bands`` is bounded by pp read and its keys and items
written.
"""
from __future__ import annotations

import dataclasses
import importlib.util
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
SPLITS = (2, 4, 8)   # blocks per tile of the split kernels (phases 5, 13b, 14b)
# published peaks of one H100 SXM: fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(ops, nbytes):
    """(ms, 'operations' or 'bytes', how): the least time the card could
    take for ``ops`` float32 operations and ``nbytes`` bytes moved; the
    timing tools of tools/ read it too."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes', \
        f'{ops:,} operations ({t_ops:.6f} ms), {nbytes:,} bytes ({t_bytes:.6f} ms)'


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
SPLIT_TOL = 1e-5     # the f_px and px_f forwards vs the plain version of their split
AGGR_RTOL = 1e-3     # ... their aggregates, relative
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


def sphere_obj_text(v, f, rings, segs, mtl=None, material='sphere'):
    """OBJ text of ``uv_sphere(rings, segs)``: v, vt (the sphere's (u, v),
    one column more than the vertices so that the seam's faces do not wrap)
    and vn (the unit position), faces as v/vt/vn."""
    fs = f % segs
    wrap = (fs == 0) & (fs.max(axis=1, keepdims=True) == segs - 1)
    col = np.where(wrap, segs, fs)
    vt_id = (f // segs) * (segs + 1) + col
    r, c = np.divmod(np.arange((rings + 1) * (segs + 1)), segs + 1)
    vt = np.stack([c / segs, 1 - r / rings], 1)
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    lines = [f'mtllib {mtl}'] if mtl else []
    lines += ['v %.8f %.8f %.8f' % tuple(x) for x in v]
    lines += ['vt %.8f %.8f' % tuple(x) for x in vt]
    lines += ['vn %.8f %.8f %.8f' % tuple(x) for x in vn]
    lines.append(f'usemtl {material}')
    lines += ['f %d/%d/%d %d/%d/%d %d/%d/%d' % (
        a + 1, ta + 1, a + 1, b + 1, tb + 1, b + 1, c_ + 1, tc + 1, c_ + 1)
        for (a, b, c_), (ta, tb, tc) in zip(f.tolist(), vt_id.tolist())]
    return '\n'.join(lines) + '\n'


def seeded_pngs(codec, directory, rng, size=1024):
    """A seeded RGB map_Kd (smooth colour waves and noise) and a gray bump
    map written as RGB with equal channels, both by the port's PNG codec."""
    y, x = np.mgrid[0:size, 0:size] / size
    kd = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * x + k * 0.3)) * np.cos(2 * np.pi * 2 * y)
                   for k in range(3)], -1) + rng.uniform(-0.1, 0.1, (size, size, 3))
    bump = 0.5 + 0.25 * np.sin(2 * np.pi * 8 * x) * np.sin(2 * np.pi * 6 * y) \
        + rng.uniform(-0.05, 0.05, (size, size))
    kd8 = (np.clip(kd, 0, 1) * 255).astype(np.uint8)
    bump8 = (np.clip(bump, 0, 1) * 255).astype(np.uint8)
    (directory / 'kd.png').write_bytes(codec.encode_png(kd8))
    (directory / 'bump.png').write_bytes(codec.encode_png(np.stack([bump8] * 3, -1)))
    return kd8


def oriented(verts, tris, outward):
    """Faces [n,3] wound so that each face's normal cross(v2-v1, v0-v1)
    points along ``outward(centroid)``."""
    fv = verts[tris]
    n = np.cross(fv[:, 2] - fv[:, 1], fv[:, 0] - fv[:, 1])
    flip = (n * outward(fv.mean(1))).sum(1) < 0
    return np.where(flip[:, None], tris[:, ::-1], tris)


def scene_obj_text(sphere_v, sphere_f):
    """OBJ and MTL text of phase 15's scene: a textured floor, a mirror quad
    lying on it, the sphere (lifted to stand on the floor) and a box."""
    groups, verts = [], []

    def add(name, v, f):
        groups.append((name, f + sum(len(x) for x in verts)))
        verts.append(v)

    up = lambda c: np.array([0.0, 1.0, 0.0])                      # noqa: E731
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    floor = np.array([[-3, -1, -2], [3, -1, -2], [3, -1, 5], [-3, -1, 5]], np.float32)
    add('floor', floor, oriented(floor, quad, up))
    mirror = np.array([[-1.6, -0.99, -0.6], [0.4, -0.99, -0.6], [0.4, -0.99, 0.6],
                       [-1.6, -0.99, 0.6]], np.float32)
    add('mirror', mirror, oriented(mirror, quad, up))
    centre = np.array([-0.3, -0.15, 1.4], np.float32)
    sv = sphere_v + centre
    add('sphere', sv, oriented(sv, sphere_f, lambda c: c - centre))
    lo, hi = np.array([0.8, -1.0, 0.2]), np.array([1.6, -0.2, 1.0])
    box = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                    for z in (lo[2], hi[2])], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = np.array([t for a, b, c, d in quads for t in ([a, b, c], [a, c, d])])
    add('box', box, oriented(box, tris, lambda c: c - (lo + hi) / 2))
    allv = np.concatenate(verts)
    lines = ['mtllib scene.mtl'] + ['v %.8f %.8f %.8f' % tuple(x) for x in allv]
    lines += ['vt 0 0', 'vt 1 0', 'vt 1 1', 'vt 0 1']
    for name, f in groups:
        lines.append(f'usemtl {name}')
        uv = [(1, 2, 3), (1, 3, 4)] if name == 'floor' else [(1, 2, 3)] * len(f)
        lines += ['f %d/%d %d/%d %d/%d' % (a + 1, ta, b + 1, tb, c + 1, tc)
                  for (a, b, c), (ta, tb, tc) in zip(f.tolist(), uv * (len(f) // len(uv)))]
    mtl = ['newmtl floor', 'Kd 0.8 0.8 0.8', 'map_Kd kd.png', 'newmtl mirror', 'Kd 0.3 0.3 0.35',
           'newmtl sphere', 'Kd 0.9 0.5 0.3', 'newmtl box', 'Kd 0.2 0.5 0.9']
    return '\n'.join(lines) + '\n', '\n'.join(mtl) + '\n', [g[0] for g in groups]


SCENE_LIGHTS = (
    dict(type='point', position=[0.0, 3.0, -1.0], direction=[0.0, -1.0, 0.3], intensity=0.8,
         shadow=True),
    dict(type='area', position=[-2.0, 3.0, -1.0], direction=[0.5, -1.0, 0.5], intensity=0.6,
         shadow=True),
    dict(type='directional', position=[2.0, 4.0, -2.0], direction=[-0.4, -1.0, 0.4],
         intensity=0.6, shadow=True, viewing_scale=0.25),
    dict(type='ambient', intensity=0.2, shadow=False),
)
SCENE_CAMERA = dict(camera_mode='look', eye=[0.0, 1.0, -3.5], camera_direction=[0.0, -0.3, 1.0])


class StageClock:
    """Host-clock ms of named stages, each exclusive of the stages it calls
    (synchronised before and after)."""

    def __init__(self):
        self.ms, self.stack = {}, []

    def wrap(self, name, fn):
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                child = self.stack.pop()
                dt = (time.perf_counter() - t0) * 1e3
                self.ms[name] = self.ms.get(name, 0.0) + dt - child
                if self.stack:
                    self.stack[-1] += dt
            return out
        return run


def files_and_scene(h):
    """Phase 15: the files and the scene at full width (module docstring).
    ``h``: main's helpers (dev, smi, timed, zero_counts, read_counts,
    sample_pixels, pixels_vs_plain, no_dir, no_pxg).  Returns the numbers
    the kernels line and the log report."""
    import importlib
    import shutil
    import tempfile

    import torch
    from jrender_tpu_torch import Light, Mesh, Render, Renderer, Scene
    from jrender_tpu_torch.io import image as codec
    from jrender_tpu_torch.io.load_obj import parse_faces, parse_vertices
    from jrender_tpu_torch.native import objloader
    from jrender_tpu_torch.ops.softras import make_params, torch_impl
    from jrender_tpu_torch.utils.primitives import uv_sphere

    L = importlib.import_module('jrender_tpu_torch.lighting.lighting')   # SSS's stages
    dev, smi = h['dev'], h['smi']
    out = {'k1_launches': {}, 'ms': {}}
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_files_'))
    try:
        rng = np.random.RandomState(SEED + 15)
        # ---- a. files ----------------------------------------------------
        log('phase 15a: OBJ, MTL and PNG files of the 39,474-face sphere')
        rings, segs = 130, 153
        v, f = uv_sphere(rings, segs)
        t0 = time.perf_counter()
        (tmp / 'sphere.obj').write_text(sphere_obj_text(v, f, rings, segs, mtl='sphere.mtl'))
        (tmp / 'sphere.mtl').write_text('newmtl sphere\nKd 1 1 1\nmap_Kd kd.png\n'
                                        'map_normal -bm bump.png\n')
        seeded_pngs(codec, tmp, rng)
        out['ms']['write_files'] = (time.perf_counter() - t0) * 1e3
        path = str(tmp / 'sphere.obj')
        out['image_library'] = codec.library()
        log(f'  image library: {out["image_library"]} (imageio, then PIL, then the codec)')
        if not objloader.available():
            raise AssertionError('the native OBJ parser did not build')
        t0 = time.perf_counter()
        parsed = objloader.parse_obj_native(path)
        t_native = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lines = open(path).readlines()
        py_v, py_f = parse_vertices(lines), parse_faces(lines)
        t_python = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(parsed.faces, py_f) and np.array_equal(parsed.faces, f)):
            raise AssertionError('the native and Python parsers disagree on the faces')
        if not np.array_equal(parsed.vertices, py_v):
            raise AssertionError('the native and Python parsers disagree on the vertices')
        if not np.array_equal(parsed.vertices, np.float32([[float('%.8f' % x) for x in r]
                                                           for r in v])):
            raise AssertionError('the parsed vertices are not the written ones')
        out['ms'].update(parse_native=t_native, parse_python=t_python)
        log(f'  native parser {t_native:.1f} ms, Python parser {t_python:.1f} ms: faces equal '
            f'to the bit ({f.shape[0]} faces), vertices equal  [{smi}]')

        # ---- b. demo 1's path -------------------------------------------
        log("phase 15b: demo 1's path, Mesh.from_obj(load_texture=True, texture_res=5) and "
            "8 frames at 1024 px")
        h['zero_counts']()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = Mesh.from_obj(path, load_texture=True, texture_res=5, texture_type='surface')
        torch.cuda.synchronize()
        out['ms']['load_demo1'] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu = Mesh.from_obj(path, load_texture=True, texture_res=5, device='cpu')
        out['ms']['load_demo1_cpu'] = (time.perf_counter() - t0) * 1e3
        load_err = {name: (getattr(mesh, name).cpu() - getattr(cpu, name)).abs().max().item()
                    for name in ('textures', 'normal_textures', 'TBN')}
        if not load_err['textures'] <= 1e-6:
            raise AssertionError(f'demo 1 load: textures on the card {load_err} from the CPU')
        renderer = Renderer(image_size=1024)
        azimuths = [i * 360 // FRAMES for i in range(FRAMES)]
        h['zero_counts']()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = []
        with torch.no_grad():
            for az in azimuths:
                mesh.reset_()
                renderer.transform.set_eyes_from_angles(2.732, 30, az)
                frames.append(renderer.render_mesh(mesh, mode=None))
        torch.cuda.synchronize()
        out['ms']['demo1_frame'] = (time.perf_counter() - t0) * 1e3 / FRAMES
        counts = h['read_counts']()
        h['no_dir']('phase 15b')
        h['no_pxg']('phase 15b')
        if counts['softras_fwd'] != FRAMES:
            raise AssertionError(f'demo 1 frames: {counts}')
        out['k1_launches']['demo1_frames'] = counts['softras_fwd']
        mesh.reset_()
        renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[1])
        with torch.no_grad():
            lit = renderer.transform(renderer.lighting(mesh, renderer.transform.eyes))
        alpha1, rgb1 = frames[1]
        out['err'] = h['pixels_vs_plain'](
            'demo 1 frame 1 vs plain', lit.face_vertices.reshape(1, -1, 9).contiguous(),
            lit.face_textures.contiguous(), make_params(image_size=1024),
            torch.cat([rgb1, alpha1[:, None]], dim=1))
        mesh.reset_()
        t0 = time.perf_counter()
        mesh.save_obj(str(tmp / 'saved.obj'), save_texture=True, texture_res_out=32)
        back = Mesh.from_obj(str(tmp / 'saved.obj'), load_texture=True, texture_res=5)
        torch.cuda.synchronize()
        out['ms']['round_trip'] = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(back.vertices, mesh.vertices) and torch.equal(back.faces, mesh.faces)):
            raise AssertionError('save_obj round trip: vertices or faces changed')
        e_rt = (back.textures - mesh.textures).abs().max().item()
        if not e_rt <= 1 / 255 + 1e-6:
            raise AssertionError(f'save_obj round trip: textures {e_rt:.3g} apart')
        log(f'  load {out["ms"]["load_demo1"]:.0f} ms on the card ({out["ms"]["load_demo1_cpu"]:.0f} '
            f'on the CPU; the card from the CPU: {load_err}), {FRAMES} frames at '
            f'{out["ms"]["demo1_frame"]:.2f} ms each (host clock), K1 launches {counts["softras_fwd"]}; '
            f'save_obj(save_texture=True, 32-px atlas) and load: {out["ms"]["round_trip"]:.0f} ms, '
            f'vertices and faces exact, textures within {e_rt:.3g} (8-bit atlas)  [{smi}]')
        del cpu, back, frames, lit

        # ---- c. demo 1.5's path: SSS ----------------------------------------
        log("phase 15c: demo 1.5's path, with_SSS, texture_res=15, normalization, 1024 px")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sss_mesh = Mesh.from_obj(path, load_texture=True, texture_res=15, normalization=True,
                                 with_SSS=True)
        torch.cuda.synchronize()
        out['ms']['load_demo15'] = (time.perf_counter() - t0) * 1e3
        log(f'  textures {tuple(sss_mesh.textures.shape)}, '
            f'{sss_mesh.textures.numel() * 4 / 1e6:.0f} MB, loaded in '
            f'{out["ms"]["load_demo15"]:.0f} ms')
        sss_renderer = Renderer(image_size=1024)
        n_sss = 2
        h['zero_counts']()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for az in azimuths[:n_sss]:
                sss_mesh.reset_()
                sss_renderer.transform.set_eyes_from_angles(2.732, 30, az)
                alpha, rgb = sss_renderer.render_mesh(sss_mesh, mode=None)
                if not (torch.isfinite(rgb).all() and alpha.gt(0.5).float().mean() > 0.05):
                    raise AssertionError('demo 1.5 frame: non-finite or empty')
        torch.cuda.synchronize()
        out['ms']['demo15_frame'] = (time.perf_counter() - t0) * 1e3 / n_sss
        counts = h['read_counts']()
        if counts['softras_fwd'] != 4 * n_sss:
            raise AssertionError(f'demo 1.5: {counts} for {n_sss} frames (3 UV maps + 1 each)')
        out['k1_launches']['demo15_frames'] = counts['softras_fwd']

        # the stages of one frame's SSS, each held and timed
        sss_mesh.reset_()
        sss_renderer.transform.set_eyes_from_angles(2.732, 30, azimuths[0])
        clock = StageClock()
        with torch.no_grad():
            diffuse, specular = clock.wrap('light', sss_renderer.lighting.surface_terms)(
                sss_mesh, sss_renderer.transform.eyes)
            texs = L.sss_map_textures(diffuse, specular, sss_mesh)
            maps = [clock.wrap(f'uv_map_{k}', L.sss_rasterize_uv)(sss_mesh.face_texcoords, t)
                    for k, t in zip(('world', 'irradiance', 'specular'), texs)]
            blurred = clock.wrap('blur', L.sss_blur)(maps[0], maps[1])
            final = blurred * maps[1] + maps[2]
            new_tex = clock.wrap('resample', L.sss_textures)(final, sss_mesh)
            if not (torch.isfinite(new_tex).all() and new_tex.shape == sss_mesh.textures.shape):
                raise AssertionError('SSS textures: non-finite or misshapen')
        out['ms']['sss'] = dict(clock.ms)
        uvf = L.sss_uv_faces(sss_mesh.face_texcoords)
        p_sss = L.sss_params()
        idx, (xp, yp) = h['sample_pixels'](L.SSS_IMAGE_SIZE)
        for name, t, m in zip(('world', 'irradiance', 'specular'), texs, maps):
            col, _, _ = torch_impl.forward_pixels(uvf, t, p_sss, xp, yp, chunk_pairs=1 << 24)
            got = m.reshape(-1, 3)[idx]
            # the world map holds 0-255 coordinates: its tolerance scales with them
            tol = TOL * (255.0 if name == 'world' else 1.0)
            f_b, e_b = beyond(got, col[0, :, :3], tol, pixel_dim=-1)
            check(f'SSS {name} map', f_b)
            log(f'  SSS {name} map at 2048 px: {SAMPLES} pixels, {f_b:.4f} beyond {tol:g} '
                f'(max {e_b:.3g}) of the plain version')
        log(f'  SSS stages of one frame, ms (host clock): '
            f'{ {k: round(x, 3) for k, x in clock.ms.items()} }; frame with SSS '
            f'{out["ms"]["demo15_frame"]:.1f} ms, K1 launches {counts["softras_fwd"]} for '
            f'{n_sss} frames  [{smi}]')
        del sss_mesh, texs, maps, blurred, final, new_tex, diffuse, specular

        # SSS's whole texture step on demo 2's sphere: the card against the
        # plain UV maps (on the card) and the blur and resampling on the CPU
        v2, f2 = uv_sphere(26, 26)
        (tmp / 'demo2.obj').write_text(sphere_obj_text(v2 * np.float32(0.5 / 0.85), f2, 26, 26,
                                                       mtl='sphere.mtl'))
        m2 = Mesh.from_obj(str(tmp / 'demo2.obj'), load_texture=True, texture_res=4,
                           with_SSS=True)
        with torch.no_grad():
            d2, s2 = Renderer(image_size=256).lighting.surface_terms(m2, (0.0, 1.0, -2.7))
            t2 = L.sss_map_textures(d2, s2, m2)
            maps2 = [L.sss_rasterize_uv(m2.face_texcoords, t) for t in t2]
            card = L.SSS(d2, s2, m2)
            xg, yg = torch_impl.pixel_grid(L.SSS_IMAGE_SIZE, dev)
            uvf2 = L.sss_uv_faces(m2.face_texcoords)
            plain_maps = []
            for t in t2:
                col, _, _ = torch_impl.forward_pixels(uvf2, t, L.sss_params(), xg, yg,
                                                      chunk_pairs=1 << 26)
                plain_maps.append(col[0, :, :3].reshape(L.SSS_IMAGE_SIZE, L.SSS_IMAGE_SIZE, 3))
            for name, got, want in zip(('world', 'irradiance', 'specular'), maps2, plain_maps):
                tol = TOL * (255.0 if name == 'world' else 1.0)
                f_b, e_b = beyond(got.reshape(-1, 3), want.reshape(-1, 3), tol, pixel_dim=-1)
                check(f'demo 2 SSS {name} map, whole', f_b)
            m2c = Mesh(m2.vertices.cpu(), m2.faces.cpu(), textures=m2.textures.cpu(),
                       texture_res=4, face_texcoords=m2.face_texcoords.cpu(), with_SSS=True,
                       device='cpu')
            cpu_maps = [x.cpu() for x in maps2]
            cpu_tex = L.sss_textures(L.sss_blur(cpu_maps[0], cpu_maps[1]) * cpu_maps[1]
                                     + cpu_maps[2], m2c)
        scale = cpu_tex.abs().max().item()
        e_sss = (card.cpu() - cpu_tex).abs().max().item()
        if not e_sss <= 1e-4 * scale:
            raise AssertionError(f'demo 2 SSS textures: {e_sss:.3g} from the CPU run '
                                 f'(max {scale:.3g})')
        out['sss_demo2_err'] = e_sss / scale
        log(f"  demo 2's sphere ({f2.shape[0]} faces): the three whole UV maps equal the plain "
            f'version (all but {EDGE_FRAC} of pixels within tolerance); the textures of the '
            f'blur and resampling from them within {e_sss / scale:.3g} of max of the CPU run')
        del m2, m2c, maps2, plain_maps, card, cpu_tex, cpu_maps, t2

        # ---- d. the scene at 1024 px ------------------------------------------
        log('phase 15d: the scene (floor, mirror, glossy sphere, box; point, area, directional '
            'and ambient lights) at 1024 px')
        obj_text, mtl_text, names = scene_obj_text(v, f)
        (tmp / 'scene.obj').write_text(obj_text)
        (tmp / 'scene.mtl').write_text(mtl_text)
        scene = Scene.load_scene_from_obj(str(tmp / 'scene.obj'))
        for light in SCENE_LIGHTS:
            scene.append_light(Light(**light))
        idx_of = {n: scene.name_dic[n] for n in names}
        scene.set_reflection(idx_of['mirror'], 'mirror')
        scene.set_roughness(idx_of['sphere'], 0.3)
        idx, (xp, yp) = h['sample_pixels'](1024)
        scene_runs = {}
        for ssr_mode in ('naive', 'hiz'):
            for shading in ('Cook_Torrance', 'blinn_phong'):
                scene.set_reflection(idx_of['sphere'],
                                     'glossy' if shading == 'Cook_Torrance' else 'diffuse')
                render = Render(image_size=1024, ssr_mode=ssr_mode, **SCENE_CAMERA)
                clock = StageClock()
                record = []
                raster = render.Rasterize

                def rasterize(face_proj, face_info, MSAA=False, fill_back=True,
                              texture_type='vertex', _raster=raster, _r=render, _rec=record):
                    img = _raster(face_proj, face_info, MSAA, fill_back, texture_type)
                    _rec.append((face_proj, face_info, _r.raster_params(MSAA, fill_back,
                                                                        texture_type),
                                 img, _r._last_aggrs))
                    return img
                render.Rasterize = clock.wrap('rasterize', rasterize)
                for name in ('light_visibility', 'SSR', 'SSSR', 'fragment_shader'):
                    setattr(render, name, clock.wrap(name, getattr(render, name)))
                scene.set_render(render)
                h['zero_counts']()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    img = scene.deferred_render(shading=shading)
                torch.cuda.synchronize()
                total = (time.perf_counter() - t0) * 1e3
                k1 = h['read_counts']()['softras_fwd']
                h['no_dir']('phase 15d')
                h['no_pxg']('phase 15d')
                if k1 != len(record) or not torch.isfinite(img).all() or img.max() < 0.1:
                    raise AssertionError(f'scene {ssr_mode} {shading}: K1 {k1}, '
                                         f'{len(record)} rasterizations, max {img.max()}')
                errs = []
                for face_proj, face_info, p, got, aggrs in record:
                    F = face_proj.shape[0]
                    col, ag, _ = torch_impl.forward_pixels(
                        face_proj.reshape(1, F, 9),
                        face_info.reshape((1, F) + tuple(face_info.shape[1:])), p, xp, yp,
                        chunk_pairs=1 << 24)
                    f_rgb, e_rgb = beyond(got.reshape(-1, 3)[idx], col[0, :, :3], TOL,
                                          pixel_dim=-1)
                    depth = aggrs[0, 0].reshape(-1)[idx]
                    f_z, _ = beyond(depth, ag[0, :, 0], TOL * (1 + ag[0, :, 0].abs()))
                    f_id = (aggrs[0, 1].reshape(-1)[idx] != ag[0, :, 1]).float().mean().item()
                    for what, frac in (('buffer', f_rgb), ('depth', f_z), ('face ids', f_id)):
                        check(f'scene {ssr_mode} {shading} {what}', frac)
                    errs.append(e_rgb)
                    out['err'] = max(out['err'], e_rgb)
                with torch.no_grad():
                    t0 = time.perf_counter()
                    ao = render.SSAO(img)
                    torch.cuda.synchronize()
                    t_ao = (time.perf_counter() - t0) * 1e3
                    t0 = time.perf_counter()
                    do = render.SSDO(img)
                    torch.cuda.synchronize()
                    t_do = (time.perf_counter() - t0) * 1e3
                if not (torch.isfinite(ao).all() and torch.isfinite(do).all()):
                    raise AssertionError('SSAO / SSDO: non-finite')
                ms = {k: round(x, 2) for k, x in clock.ms.items()}
                ms.update(total=round(total, 2), SSAO=round(t_ao, 2), SSDO=round(t_do, 2))
                scene_runs[f'{ssr_mode}/{shading}'] = {'k1': k1, 'ms': ms}
                log(f'  {ssr_mode} {shading}: K1 launches {k1} per deferred_render, '
                    f'{len(record)} buffers and depth maps held on {SAMPLES} pixels each (max '
                    f'rgb err {max(errs):.3g}); host-clock ms by stage {ms}  [{smi}]')
        out['scene'] = scene_runs
        out['k1_launches']['deferred_render'] = {k: r['k1'] for k, r in scene_runs.items()}
        del scene, record, img

        # the whole pipeline at 128 px on the 3,330-face sphere, card against CPU
        v3, f3 = uv_sphere(38, 45)
        obj_text, mtl_text, names = scene_obj_text(v3, f3)
        (tmp / 'scene3330.obj').write_text(obj_text)
        (tmp / 'scene.mtl').write_text(mtl_text)
        gcpu = torch.Generator().manual_seed(SEED + 16)
        draws = torch.rand((32, 2, 128, 128), generator=gcpu)
        ao_draws = torch.rand((256, 3), generator=gcpu)
        images = {}
        for device in ('cuda', 'cpu'):
            s = Scene.load_scene_from_obj(str(tmp / 'scene3330.obj'), device=device)
            for light in SCENE_LIGHTS:
                s.append_light(Light(**light))
            s.set_reflection(s.name_dic['mirror'], 'mirror')
            s.set_reflection(s.name_dic['sphere'], 'glossy')
            s.set_roughness(s.name_dic['sphere'], 0.3)
            s.set_render(Render(image_size=128, device=device, **SCENE_CAMERA))
            s.render.sssr_samples = draws
            t0 = time.perf_counter()
            with torch.no_grad():
                img = s.deferred_render('Cook_Torrance')
                img = s.render.SSAO(img, samples=ao_draws)
            if device == 'cuda':
                torch.cuda.synchronize()
            images[device] = (img.cpu(), s.render.faces_ind_buffer.cpu(),
                              (time.perf_counter() - t0) * 1e3)
        f_img, e_img = beyond(images['cuda'][0], images['cpu'][0], 1e-4, pixel_dim=-1)
        f_ids = (images['cuda'][1] != images['cpu'][1]).float().mean().item()
        check('scene at 128 px, card vs CPU', f_img)
        check('scene at 128 px face ids, card vs CPU', f_ids)
        out['scene128'] = {'beyond': f_img, 'max': e_img, 'ids_beyond': f_ids,
                           'ms_card': images['cuda'][2], 'ms_cpu': images['cpu'][2]}
        log(f'  whole pipeline at 128 px, 3,330-face sphere (Cook-Torrance, SSAO): card vs CPU '
            f'{f_img:.4f} of pixels beyond 1e-4 (max {e_img:.3g}), face ids {f_ids:.4f} apart; '
            f'{images["cuda"][2]:.0f} ms on the card, {images["cpu"][2]:.0f} on the CPU')

        # ---- e. voxels ----------------------------------------------------------
        log('phase 15e: Mesh.voxelize of the 39,474-face sphere')
        vs = v * np.float32(0.45 / 0.85)       # inside the grid's unit cube
        vm = Mesh(vs, f)
        vc = Mesh(vs, f, device='cpu')
        t0 = time.perf_counter()
        g32 = vm.voxelize(32)
        torch.cuda.synchronize()
        t32 = (time.perf_counter() - t0) * 1e3
        if not torch.equal(g32.cpu(), vc.voxelize(32)):
            raise AssertionError('voxelize(32): the card and the CPU disagree')
        grids, t128 = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            grids.append(vm.voxelize(128))
            torch.cuda.synchronize()
            t128.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(grids[0], grids[1]):
            raise AssertionError('voxelize(128): two runs disagree')
        out['ms'].update(voxelize_32=t32, voxelize_128=t128)
        log(f'  voxelize(32) {t32:.0f} ms, equal to the CPU grid ({int(g32.sum())} cells); '
            f'voxelize(128) twice, equal: {t128[0]:.0f} / {t128[1]:.0f} ms '
            f'({int(grids[0].sum())} cells)  [{smi}]')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out

# ---- phase 16: volume rendering and NeRF ----------------------------------------

NERF_TOL = 1e-4          # 16a: card against the CPU, rgb, acc, rgb0, share of each one's max
NERF_DISP_TOL = 1e-3     # 16a: disp, share of its max (first read 7.6e-5 against rgb's
#                          3.0e-6: disp = 1 / (depth / acc) is the worst conditioned of the
#                          four; which rays carry it was not traced)
NERF_GRAD_TOL = 1e-3     # 16a: each layer's weight gradient, share of its max
NERF_RESUME_TOL = 1e-6   # 16d: a resumed run against the straight one
NERF_BF16_MEAN = 0.02    # 16d: bf16 operands against f32, mean relative (the CPU test's)
NERF_LEARNED_DB = 3.0    # 16b: the PSNR rise bench.py's nerf_rows calls learned
NERF_H = NERF_W = 400    # bench.py's nerf_rows: a 400² target, focal 555.5, near 2, far 6
NERF_FOCAL = 555.5


def nerf_lego_args(**kw):
    """bench.py's nerf_rows configuration: the lego config's full width, 8 x
    256 coarse and fine, view directions, 1,024 rays, 64 + 128 samples."""
    from types import SimpleNamespace
    base = dict(netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256, N_rand=1024,
                lrate=5e-4, lrate_decay=500, chunk=32768, netchunk=65536, no_batching=True,
                no_reload=True, ft_path=None, N_iters=10, N_samples=64, N_importance=128,
                perturb=1.0, use_viewdirs=True, i_embed=0, multires=10, multires_views=4,
                raw_noise_std=0.0, precrop_iters=0, precrop_frac=0.5, dataset_type='blender',
                white_bkgd=True, lindisp=False, no_ndc=True, seed=0, basedir='unused',
                expname='bench', steps_per_dispatch=10, accumulation_steps=1, valid_ratio=-1.0,
                net_precision='f32', embed_depth=False)
    base.update(kw)
    return SimpleNamespace(**base)


def nerf_target(H=NERF_H, W=NERF_W):
    """bench.py's learnable target (bench.py:313-322): a smooth colour field
    and two discs."""
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing='ij')
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx) * np.cos(4 * yy)], -1)
    for (cy, cx, rad, ch) in ((0.35, 0.6, 0.18, 0), (0.7, 0.3, 0.12, 2)):
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
        img[m, ch] = 0.9
        img[m, (ch + 1) % 3] = 0.1
    return img.astype(np.float32)


def nerf_macs_per_point(D=8, W=256, input_ch=63, input_ch_views=27, skips=(4,)):
    """Multiply-adds a point through the NeRF MLP with view directions."""
    macs, fan_in = 0, input_ch
    for i in range(D):
        macs += fan_in * W
        fan_in = W + input_ch if i in skips else W
    return macs + W * 1 + W * W + (W + input_ch_views) * (W // 2) + (W // 2) * 3


def nerf_blender_scene(root, codec, n=3, H=64):
    """A Blender-format scene of 3 views a split at H px (a shaded disc that
    moves with the pose), written through the port's image IO."""
    from jrender_tpu_torch.nerf.dataset import pose_spherical
    frames = {s: [] for s in ('train', 'val', 'test')}
    for split in frames:
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            ys, xs = np.meshgrid(np.arange(H), np.arange(H), indexing='ij')
            cx = H / 2 + H / 6 * np.sin(2 * np.pi * i / n)
            r = np.sqrt((xs - cx) ** 2 + (ys - H / 2) ** 2)
            v = np.clip(1.0 - r / (H / 3), 0, 1)
            rgba = np.stack([v, v * 0.5, v * 0.25, (v > 0).astype(float)], -1)
            codec.imwrite(str(root / split / f'r_{i}.png'), (rgba * 255).astype(np.uint8))
            frames[split].append({'file_path': f'{split}/r_{i}',
                                  'transform_matrix': pose_spherical(360.0 * i / n, -30.0,
                                                                     4.0).tolist()})
    for split, fr in frames.items():
        (root / f'transforms_{split}.json').write_text(
            json.dumps({'camera_angle_x': 0.6911, 'frames': fr}))


NERF_TRAIN_CFG = """expname = {name}
dataset_type = blender
white_bkgd = True
no_batching = True
use_viewdirs = True
N_samples = 32
N_importance = 32
N_rand = 256
netdepth = 4
netwidth = 64
netdepth_fine = 4
netwidth_fine = 64
multires = 6
multires_views = 3
lrate = 0.005
precrop_iters = 10
N_iters = {iters}
steps_per_dispatch = 10
i_print = 10
i_weights = 20
i_img = 40
testskip = 1
"""


def nerf_stack(h):
    """Phase 16: volume rendering and NeRF on the card (module docstring).
    ``h``: main's helpers (dev, smi, zero_counts, read_all).  Returns the
    numbers the log reports."""
    import shutil
    import tempfile

    import torch
    from jrender_tpu_torch.io import image as codec
    from jrender_tpu_torch.nerf import config, trainer
    from jrender_tpu_torch.nerf.model import img2mse, mse2psnr
    from jrender_tpu_torch.vol import render_pass
    from jrender_tpu_torch.vol.camera import pinhole_get_rays

    dev, smi = h['dev'], h['smi']
    out = {}
    h['zero_counts']()
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    precision = torch.get_float32_matmul_precision()
    log(f'phase 16: torch.backends.cuda.matmul.allow_tf32 = {tf32}, '
        f'float32 matmul precision {precision!r}')
    if tf32 or precision != 'highest':
        raise AssertionError('phase 16: TF32 would enter the MLP products')
    out['allow_tf32'] = tf32

    H, W, focal, near, far = NERF_H, NERF_W, NERF_FOCAL, 2.0, 6.0
    target = nerf_target()
    pose = np.eye(4, dtype=np.float32)[:3, :4]
    pose[2, 3] = -4.0
    macs = nerf_macs_per_point()
    step_points = 1024 * (64 + 64 + 128)      # coarse, and fine on both sample sets
    step_flop = 3 * 2 * macs * step_points      # forward, and a backward of twice its work
    frame_flop = 2 * macs * H * W * (64 + 64 + 128)

    # ---- a. one batch on the card against the CPU --------------------------------
    log('phase 16a: one lego batch (8 x 256 coarse and fine, view directions, 1,024 rays, '
        '64 + 128 samples, white_bkgd, fed draws) on the card against the CPU')
    args = nerf_lego_args()
    rng = np.random.RandomState(SEED + 16)
    n = args.N_rand
    ys, xs = rng.randint(0, H, n), rng.randint(0, W, n)
    ro, rd = pinhole_get_rays(H, W, focal, torch.from_numpy(pose))
    ro, rd = ro[ys, xs].contiguous(), rd[ys, xs].contiguous()
    tgt = torch.from_numpy(target[ys, xs])
    draws = {'t_rand': torch.from_numpy(rng.rand(n, args.N_samples).astype(np.float32)),
             'u': torch.from_numpy(rng.rand(n, args.N_importance).astype(np.float32))}
    layers = (('coarse', 'pts_linears', 0), ('fine', 'pts_linears', 5),
              ('fine', 'views_linears', 0))

    def batch(device):
        rk, _, _, nets, _ = trainer.create_nerf(args, device=device)
        rk.pop('ndc', None)
        rk['lindisp'] = False
        nq = rk.pop('network_query_fn')
        rgb, disp, acc, extras = render_pass.render(
            H, W, focal, chunk=n, rays=(ro.to(device), rd.to(device)), ndc=False,
            near=near, far=far, draws={k: v.to(device) for k, v in draws.items()},
            network_fn=nets['coarse'], network_fine=nets['fine'], network_query_fn=nq, **rk)
        t_ = tgt.to(device)
        (img2mse(rgb, t_) + img2mse(extras['rgb0'], t_)).backward()
        outs = {'rgb': rgb, 'disp': disp, 'acc': acc, 'rgb0': extras['rgb0']}
        grads = {f'{n}.{k}[{i}].w': getattr(nets[n], k)[i].w.grad for n, k, i in layers}
        return ({k: v.detach().cpu().double() for k, v in outs.items()},
                {k: v.cpu().double() for k, v in grads.items()})

    t0 = time.perf_counter()
    card_o, card_g = batch(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_o, cpu_g = batch('cpu')
    t_cpu = time.perf_counter() - t0

    def share(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    errs = {k: share(card_o[k], cpu_o[k]) for k in cpu_o}
    gerrs = {k: share(card_g[k], cpu_g[k]) for k in cpu_g}
    log(f'  card against CPU, share of max: outputs {errs} (tolerance {NERF_TOL}, disp '
        f'{NERF_DISP_TOL}); weight gradients {gerrs} (tolerance {NERF_GRAD_TOL}); '
        f'{t_card:.2f} s card (first call), {t_cpu:.2f} s CPU')
    bad = [k for k, e in errs.items()
           if not e <= (NERF_DISP_TOL if k == 'disp' else NERF_TOL)] + \
        [k for k, e in gerrs.items() if not e <= NERF_GRAD_TOL]
    if bad:
        raise AssertionError(f'phase 16a: card against CPU beyond tolerance: {bad}')
    out['16a'] = {'outputs': errs, 'grads': gerrs}

    # ---- b. bench.py's NeRF row on the port ----------------------------------------
    log("phase 16b: bench.py's NeRF row: 10 + 30 + 100 steps of the no-batching step on the "
        '400² target')
    rk, rk_test, _, nets, opt = trainer.create_nerf(args, device=dev)
    rk.pop('ndc', None)
    rk['lindisp'] = False
    rk_test['lindisp'] = False
    step_fn = trainer.make_train_step(opt, rk, H, W, focal, near, far, args.N_rand, 0, 0.5,
                                      ndc=False)
    image = torch.from_numpy(target).to(dev)
    pose_d = torch.from_numpy(pose).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    psnrs = []

    def steps(s0, n, events=None):
        for i in range(n):
            if events is not None:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            _, psnr = step_fn(nets, image, pose_d, s0 + i, generator=gen)
            if events is not None:
                ev[1].record()
                events.append(ev)
            psnrs.append(psnr)
        return s0 + n

    s = steps(0, 10)
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        s = steps(s, 10, events)
    torch.cuda.synchronize()
    ev_ms = [a.elapsed_time(b) for a, b in events]
    host_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = steps(s, 1)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = steps(s, 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # where the step's device time goes: matrix products against the rest
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = steps(s, 5)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / 5
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 5
    gemm = sum(v for k, v in by_name.items()
               if any(w in k.lower() for w in ('gemm', 'cutlass', 'sm90_xmma', 'gemv')))
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    launches = len(kern) / 5
    s = steps(s, 100 - 10 - 1 - 5)
    torch.cuda.synchronize()
    ps = [float(p) for p in psnrs]
    med = float(np.median(ev_ms))
    out['16b'] = {'ms_per_step': med, 'ms_per_step_host': float(np.median(host_ms)),
                  'rays_per_s': n / med * 1e3, 'psnr_start': ps[0], 'psnr_end': ps[-1],
                  'steps': s, 'peak_bytes': peak, 'peak_above_start_bytes': peak - base,
                  'device_ms': dev_ms, 'matmul_ms': gemm, 'other_ms': dev_ms - gemm,
                  'launches': launches, 'busy': dev_ms / prof_wall, 'wall_ms_profiled': prof_wall,
                  'bound_ms': step_flop / PEAK_FP32 * 1e3, 'step_tflop': step_flop / 1e12}
    log(f'  ms/step {med:.4f} (median of 30, CUDA events; {np.median(host_ms):.4f} host clock '
        f'with synchronize), {n / med * 1e3:.1f} rays/s, bound {step_flop / PEAK_FP32 * 1e3:.3f} '
        f'ms ({step_flop / 1e12:.4f} TFLOP of float32 at {PEAK_FP32 / 1e12:.0f} TFLOPS)  [{smi}]')
    log(f'  device {dev_ms:.4f} ms a step: matrix products {gemm:.4f}, the rest {dev_ms - gemm:.4f};'
        f' {launches:.0f} launches, busy {dev_ms / prof_wall:.3f} of {prof_wall:.3f} ms; '
        f'top kernels {[(k[:60], round(v, 4)) for k, v in top]}')
    log(f'  peak device memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} above the '
        f'step\'s start); PSNR {ps[0]:.3f} -> {ps[-1]:.3f} dB over {s} steps')
    if not ps[-1] > ps[0] + NERF_LEARNED_DB:
        raise AssertionError(f'phase 16b: PSNR did not rise by {NERF_LEARNED_DB} dB: '
                             f'{ps[0]} -> {ps[-1]}')

    # ---- c. a full frame ------------------------------------------------------------
    log('phase 16c: render_full_image at 400² (chunk 32,768, netchunk 65,536), twice')
    frames, frame_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(trainer.render_full_image(H, W, focal, pose_d, nets, rk_test, 32768,
                                                near=near, far=far))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    same = all(torch.equal(a, b) for a, b in zip(*frames))
    rgb = frames[0][0]
    if not (same and rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())):
        raise AssertionError(f'phase 16c: frames differ ({same}) or are not finite')
    frame_psnr = float(mse2psnr(img2mse(rgb, image)))
    out['16c'] = {'frame_ms': frame_ms, 'equal': same, 'psnr': frame_psnr,
                  'bound_ms': frame_flop / PEAK_FP32 * 1e3, 'frame_tflop': frame_flop / 1e12}
    log(f'  frame ms {frame_ms} (host clock with synchronize), equal {same}, PSNR '
        f'{frame_psnr:.3f} dB, bound {frame_flop / PEAK_FP32 * 1e3:.1f} ms '
        f'({frame_flop / 1e12:.2f} TFLOP)  [{smi}]')

    # ---- d. the trainer ---------------------------------------------------------------
    log('phase 16d: train(args) on a Blender scene written here: 40 steps straight against 20, '
        'a checkpoint, and a resume to 40; --profile_dir; net_precision bf16')
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_nerf_'))
    try:
        nerf_blender_scene(tmp / 'data', codec)
        cfg = tmp / 'cfg.txt'

        def run(name, iters, basedir, *more):
            cfg.write_text(NERF_TRAIN_CFG.format(name=name, iters=iters))
            a = config.parse_args(['--config', str(cfg), '--datadir', str(tmp / 'data'),
                                   '--basedir', str(tmp / basedir), *more])
            t0 = time.perf_counter()
            r = trainer.train(a)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        (nets_a, opt_a, hist_a), t_a = run('r', 40, 'a', '--profile_dir', str(tmp / 'prof'))
        run('r', 20, 'b')
        (nets_b, opt_b, hist_b), _ = run('r', 40, 'b')
        diff = max(float((p - q).detach().abs().max())
                   for p, q in zip(nets_a.parameters(), nets_b.parameters()))
        if not diff <= NERF_RESUME_TOL or opt_a.count != opt_b.count:
            raise AssertionError(f'phase 16d: the resume is {diff} from straight training')
        if not np.isfinite(hist_a[-1][2]):
            raise AssertionError(f'phase 16d: training is not finite: {hist_a}')
        traces = sorted((tmp / 'prof').glob('*.json'))
        names = set()
        for p in traces:
            names |= {e.get('name') for e in json.loads(p.read_text())['traceEvents']
                      if e.get('cat') == 'kernel'}
        if not names:
            raise AssertionError(f'phase 16d: the trace {traces} names no CUDA kernel')
        val = sorted((tmp / 'a' / 'r' / 'val_imgs').glob('*.png'))
        if not val:
            raise AssertionError('phase 16d: no validation PNG')
        (_, _, hist_bf), _ = run('bf', 20, 'c', '--net_precision', 'bf16')
        if not np.isfinite(hist_bf[-1][2]):
            raise AssertionError(f'phase 16d: bf16 training is not finite: {hist_bf}')
        # bf16 operands against f32 on phase 16b's trained lego net, as the CPU test holds them
        nq32 = rk_test['network_query_fn']
        nqbf = trainer.create_nerf(nerf_lego_args(net_precision='bf16'),
                                   device=dev)[1]['network_query_fn']
        g = torch.Generator(device=dev).manual_seed(SEED + 160)
        pts = torch.rand(8192, 8, 3, generator=g, device=dev) * 2 - 1
        vd = pts[:, 0] / pts[:, 0].norm(dim=-1, keepdim=True)
        with torch.no_grad():
            o32, obf = nq32(pts, vd, nets['fine']), nqbf(pts, vd, nets['fine'])
        bf_mean = float((o32 - obf).abs().mean() / (o32.abs().mean() + 1e-6))
        if not bf_mean < NERF_BF16_MEAN:
            raise AssertionError(f'phase 16d: bf16 against f32 {bf_mean}')
        out['16d'] = {'resume_max_diff': diff, 'psnr': [hist_a[0][2], hist_a[-1][2]],
                      'train_40_s': t_a, 'trace_files': len(traces), 'trace_kernels': len(names),
                      'val_png': val[-1].name, 'bf16_psnr': hist_bf[-1][2],
                      'bf16_mean_rel': bf_mean}
        log(f'  resume against straight: max |diff| {diff:.3g} (tolerance {NERF_RESUME_TOL}); '
            f'PSNR {hist_a[0][2]:.3f} -> {hist_a[-1][2]:.3f}; 40 steps {t_a:.2f} s with the '
            f'trace; trace files {len(traces)} naming {len(names)} CUDA kernels (e.g. '
            f'{sorted(names)[:3]}); val PNG {val[-1].name}; bf16 run PSNR {hist_bf[-1][2]:.3f}; '
            f'bf16 against f32 mean relative {bf_mean:.4g} (bound {NERF_BF16_MEAN})')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = h['read_all']()
    log(f'  kernel launches of the package during phase 16: {n} (the NeRF path has no kernel '
        'of its own: its products are cuBLAS matrix products)')
    out['package_kernel_launches'] = n
    return out


# ---- phase 17: the parallel stack ----------------------------------------------------

BANDS = (2, 4, 8)        # 17a: ranks emulated in one process
BAND_SUM_TOL = 1e-5      # 17a: the bands' gradients summed, share of the whole image's max
NERF_SHARE_TOL = 1e-4    # 17d: two shares' gradients summed, share of the whole batch's max


def band_soup(F, B, T, is_, seed):
    """Random triangles at ``is_`` px with two faces over most of the
    screen (big faces of a small emit cap), and tie-symmetric textures."""
    import torch
    from jrender_tpu_torch.utils.checks import tie_symmetric
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.8, 0.8, (B, F, 1, 2))
    r = rng.uniform(0.03, 0.3, (B, F, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
        + rng.uniform(-0.3, 0.3, (B, F, 3))
    xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    xy[:, 0] = [[-0.9, -0.9], [0.9, -0.8], [0.0, 0.9]]
    xy[:, 1] = [[-0.8, 0.8], [0.7, 0.9], [-0.9, -0.7]]
    z = 2.5 + rng.uniform(-0.4, 0.4, (B, F, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9)
    tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
    return torch.tensor(fv, device='cuda'), tie_symmetric(torch.tensor(tex, device='cuda'))


def parallel_stack(h):
    """Phase 17: the parallel stack on the card (module docstring).  ``h``:
    main's helpers (dev, smi, fv, tex, p: bench.py's sphere at 1024 px,
    zero_counts, read_counts, read_tiled, nerf_ms: phase 16b's ms a step or
    None).
    Returns the numbers the log reports."""
    import tempfile

    import torch
    import torch.distributed as dist
    from jrender_tpu_torch.nerf import trainer
    from jrender_tpu_torch.nerf.model import img2mse
    from jrender_tpu_torch.ops.softras import (binning, cuda_impl, make_params, route,
                                               soft_rasterize, torch_impl)
    from jrender_tpu_torch.parallel import (make_device_mesh, make_sharded_nerf_step,
                                            soft_rasterize_sharded)
    from jrender_tpu_torch.parallel import render as prender
    from jrender_tpu_torch.utils.checks import fold_ties, grad_beyond
    from jrender_tpu_torch.utils.device_time import device_ms
    from jrender_tpu_torch.vol.camera import pinhole_get_rays
    from jrender_tpu_torch.vol.ray_marching import render_rays

    dev, smi, fv, tex, p = h['dev'], h['smi'], h['fv'], h['tex'], h['p']
    out = {}
    t_phase = time.time()

    # ---- a. bands bit-equal to the whole image -----------------------------------------
    log(f'phase 17a: K1, its threshold, K2 and the reduction on bands of 16-px tile rows, '
        f'n in {BANDS}, strided and contiguous, against the whole image: bench.py\'s sphere '
        f'at 1024 px ({fv.shape[1]:,} faces, T = {tex.shape[2]}, K = {p.max_faces_id})')
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    whole = cuda_impl.prepare(fv, tex, p, for_grad=True)
    img, ag, cnt = cuda_impl.launch(whole, p)
    thr = cuda_impl.launch_thr(whole, cnt, p)
    g = torch.randn(img.shape, generator=gen, device=dev)
    rows_w = cuda_impl.launch_bwd(whole, img, ag, thr, g, p)
    gf_w, gt_w = cuda_impl.launch_reduce(whole, rows_w, p)
    gt_wf = fold_ties(gt_w)
    torch.cuda.synchronize()
    sums = {}
    for n in BANDS:
        for mode in prender.BAND_MODES:
            gf_s, gt_s = torch.zeros_like(gf_w), torch.zeros_like(gt_w)
            bands = []
            for r in range(n):
                st = prender.band_forward(fv, tex, p, r, n, mode, need_grad=True)
                rows = prender.band_image_rows(st.plan, r).to(dev)
                if st.plan.route != 'binned' or st.thr is None:
                    raise AssertionError(f'phase 17a: band {r} of {n} took {st.plan}')
                for got, want, what in ((st.images, img, 'image'), (st.aggrs, ag, 'aggrs'),
                                        (st.counts, cnt, 'counts'), (st.thr, thr, 'threshold')):
                    if not torch.equal(got, want.index_select(-2, rows)):
                        raise AssertionError(f'phase 17a: band {r} of {n} ({mode}): its '
                                             f'{what} is not the whole image\'s rows')
                rb = cuda_impl.launch_bwd(st.table, st.images, st.aggrs, st.thr,
                                          g.index_select(2, rows).contiguous(), p)
                sb, sw = st.table.lists.gsrc[0], whole.lists.gsrc[0]
                emitted = sb >= 0
                if not (bool((sw[emitted] >= 0).all()) and torch.equal(
                        rb.gslots[0, sb[emitted]], rows_w.gslots[0, sw[emitted]])):
                    raise AssertionError(f'phase 17a: band {r} of {n} ({mode}): its slot rows '
                                         f'are not the whole image\'s')
                gf, gt = cuda_impl.launch_reduce(st.table, rb, p)
                gf_s, gt_s = gf_s + gf, gt_s + gt
                bands.append(st.images)
                del rb, st
            if not torch.equal(prender.assemble(torch.stack(bands), prender.band_plan(
                    p, n, dev, mode)), img):
                raise AssertionError(f'phase 17a: {n} bands ({mode}) do not assemble the image')
            e_f = ((gf_s - gf_w).abs().max() / gf_w.abs().max()).item()
            e_t = ((fold_ties(gt_s) - gt_wf).abs().max() / gt_wf.abs().max()).item()
            if not max(e_f, e_t) <= BAND_SUM_TOL:
                raise AssertionError(f'phase 17a: {n} bands ({mode}): gradient sums {e_f:.3g}, '
                                     f'{e_t:.3g} of max from the whole image\'s')
            sums[f'{n}_{mode}'] = (e_f, e_t)
            log(f'  n = {n} {mode}: maps, counts, thresholds and slot rows bit-equal to the '
                f'whole image\'s; gradient sums {e_f:.3g} (faces), {e_t:.3g} (textures) of max')
    out['grad_sum_err'] = sums
    del rows_w

    # against the band-aware plain versions at phase 3's tolerances
    for is_ in (128, 256):
        for n, mode in ((2, 'stride'), (4, 'contig'), (4, 'stride')):
            x, t = band_soup(400, 2, 4, is_, SEED + is_ + n)
            pp = make_params(image_size=is_, sigma_val=1e-3, gamma_val=1e-3,
                             max_faces_per_pixel_for_grad=4)
            plan = prender.band_plan(pp, n, dev, mode)
            worst = [0.0, 0.0, 0.0]
            for r in range(n):
                band = prender.band_of(plan, r)
                rows = prender.band_image_rows(plan, r).to(dev)
                xb = cuda_impl.prepare(x, t, pp, for_grad=True, band=band)
                xb = xb._replace(lists=binning.build_tile_lists_compact(
                    x, is_, cuda_impl.TILE, cuda_impl.TILE, pp.threshold, 6, with_inverse=True,
                    band=band))
                if not int(xb.lists.gcount.min()) >= 2:
                    raise AssertionError('phase 17a: the soup has no big faces')
                bi, ba, bc = cuda_impl.launch(xb, pp)
                bt = cuda_impl.launch_thr(xb, bc, pp)
                gb = torch.randn(bi.shape, generator=gen, device=dev)
                gf, gt = cuda_impl.soft_rasterize_bwd(x, t, bi, ba, bt, gb, pp, xb)
                wi, _, wc = torch_impl.forward_rows(x, t, pp, rows, chunk_pairs=1 << 22)
                wt_thr = torch_impl.threshold_rows(x, pp, rows, chunk_pairs=1 << 22)
                wf, wt = torch_impl.backward_rows(x, t, bi, ba, wt_thr, gb, pp, rows,
                                                  chunk_pairs=1 << 21)
                tag = f'phase 17a {is_} px band {r} of {n} ({mode})'
                f_rgb, e_rgb = beyond(bi[:, :3], wi[:, :3], TOL, pixel_dim=1)
                f_a, e_a = beyond(bi[:, 3], wi[:, 3], TOL)
                check(f'{tag} rgb', f_rgb)
                check(f'{tag} alpha', f_a)
                check(f'{tag} count', beyond(bc.float(), wc.float(), 0)[0])
                bad = ((bt - wt_thr).abs() > THR_RTOL * wt_thr.abs()).float().mean().item()
                check(f'{tag} threshold', bad, THR_FRAC)
                (f_f, e_f), (f_t, e_t) = grad_beyond(gf, wf), grad_beyond(fold_ties(gt),
                                                                          fold_ties(wt))
                check(f'{tag} face gradient', f_f, GRAD_FRAC)
                check(f'{tag} texture gradient', f_t, GRAD_FRAC)
                big = xb.lists.gpos >= 0
                check(f'{tag} face gradient of the big faces', grad_beyond(gf, wf, big)[0], 0.0)
                worst = [max(worst[0], e_rgb, e_a), max(worst[1], bad), max(worst[2], e_f, e_t)]
            log(f'  {is_} px, n = {n} {mode}, B = 2, big faces: against the plain versions '
                f'on the band\'s rows: image max {worst[0]:.3g}, threshold {worst[1]:.6f} '
                f'beyond, gradient max {worst[2]:.3g} of scale')

    # ---- b. the sharded path through a one-rank NCCL group ------------------------------
    store = tempfile.mkdtemp(prefix='jr_nccl_')
    dist.init_process_group('nccl', init_method=f'file://{store}/store', rank=0, world_size=1)
    try:
        mesh = make_device_mesh(1, 1)
        kw = dict(image_size=p.image_size, sigma_val=p.sigma_val, gamma_val=p.gamma_val,
                  max_faces_per_pixel_for_grad=p.max_faces_id)
        for layout in ('pxt', 'px_f'):
            log(f'phase 17b: soft_rasterize_sharded through a one-rank NCCL group against '
                f'soft_rasterize, JR_LAYOUT={layout}, the 1024-px sphere')
            with route.with_layout(layout):
                res = []
                for sharded in (False, True):
                    xl, tl = fv.clone().requires_grad_(True), tex.clone().requires_grad_(True)
                    h['zero_counts']()
                    im = (soft_rasterize_sharded(xl, tl, p, mesh) if sharded
                          else soft_rasterize(xl, tl, **kw))
                    (im * g).sum().backward()
                    torch.cuda.synchronize()
                    res.append((im.detach(), xl.grad, tl.grad,
                                h['read_counts']() if layout == 'pxt' else h['read_tiled']()))
            for a, b_, what in zip(res[0][:3], res[1][:3], ('image', 'face grad', 'texture grad')):
                if not torch.equal(a, b_):
                    raise AssertionError(f'phase 17b ({layout}): the {what} differs from '
                                         f'soft_rasterize\'s')
            counts = res[1][3]
            want = ({'softras_fwd': 1, 'softras_thr': 1, 'softras_bwd': 1,
                     'softras_bwd_reduce': 1} if layout == 'pxt' else
                    {'softras_fpx_fwd': 0, 'softras_fpx_bwd': 0, 'softras_pxf_fwd': 1,
                     'softras_pxf_bwd': 1})
            if counts != want:
                raise AssertionError(f'phase 17b ({layout}): launches {counts}, not {want}')
            out[f'launches_{layout}'] = counts
            log(f'  image and both gradients bit-equal to soft_rasterize\'s; launches of the '
                f'sharded step {counts}')

        # ---- c. the band balance -------------------------------------------------------
        n = 4
        log(f'phase 17c: device time of K1, its threshold and K2 on each band of {n}, strided '
            f'against contiguous, the 1024-px sphere  [{smi}]')
        kern = {'softras_fwd': ('softras_fwd_kernel',), 'softras_thr': ('softras_thr_kernel',),
                'softras_bwd': ('softras_bwd_kernel', 'softras_bwd_big_kernel')}
        fwd_e = cuda_impl._entry('softras_fwd', 'softras_fwd', cuda_impl._FwdArgs)
        thr_e = cuda_impl._entry('softras_thr', 'softras_thr', cuda_impl._ThrArgs)
        bwd_e = cuda_impl._entry('softras_bwd', 'softras_bwd', cuda_impl._BwdArgs)

        def alone(x, bi, ba, bc, bt, gb):
            """The three kernels on a band's inputs, their arguments made once
            (uncounted launches); the outputs the arguments point into are
            kept with the callable."""
            fa, fo = cuda_impl.fwd_args(x, p)
            ta, to = cuda_impl.thr_args(x, bc, p)
            ba_, bo = cuda_impl.bwd_args(x, bi, ba, bt, gb, p)

            def run():
                cuda_impl._run(fwd_e, 'softras_fwd', fa, dev)
                cuda_impl._run(thr_e, 'softras_thr', ta, dev)
                cuda_impl._run(bwd_e, 'softras_bwd', ba_, dev)
            run.outputs = (fo, to, bo, x, bi, ba, bc, bt, gb)
            return run

        whole_ms = device_ms(alone(whole, img, ag, cnt, thr, g), kern, reps=10)
        balance = {'whole': whole_ms}
        for mode in prender.BAND_MODES:
            per = []
            for r in range(n):
                st = prender.band_forward(fv, tex, p, r, n, mode, need_grad=True)
                rows = prender.band_image_rows(st.plan, r).to(dev)
                ms = device_ms(alone(st.table, st.images, st.aggrs, st.counts, st.thr,
                                     g.index_select(2, rows).contiguous()), kern, reps=10)
                cl = st.table.lists
                per.append({**ms, 'pairs': int(cl.run_counts.sum()),
                            'candidates': int(st.counts.sum()),
                            'overfull_px': int((st.counts > p.max_faces_id).sum())})
                del st
            tot = [sum(b[k] for k in kern) for b in per]
            pairs = [b['pairs'] for b in per]
            balance[mode] = {'bands': per, 'ms': tot,
                             'efficiency': float(np.mean(tot) / max(tot)),
                             'pairs_max_over_mean': float(max(pairs) / np.mean(pairs)),
                             'ms_max_over_mean': float(max(tot) / np.mean(tot))}
            log(f'  {mode}: K1+thr+K2 ms a band {[round(v, 4) for v in tot]} (whole image '
                f'{sum(whole_ms.values()):.4f}); by kernel '
                f'{[{k: round(b[k], 4) for k in kern} for b in per]}; pairs {pairs}; busiest '
                f'band / mean: pairs {max(pairs) / np.mean(pairs):.3f}, time '
                f'{max(tot) / np.mean(tot):.3f}; scaling bound (mean / max) '
                f'{np.mean(tot) / max(tot):.3f}  [{smi}]')
        out['balance_n4'] = balance

        # ---- d. the sharded NeRF step ---------------------------------------------------
        log("phase 17d: make_sharded_nerf_step at lego's widths (8 x 256, 1,024 rays, 64 + 128 "
            "samples, white background) on bench.py's target, through the one-rank group")
        args = nerf_lego_args()
        H, W = NERF_H, NERF_W
        target = nerf_target()
        pose = np.eye(4, dtype=np.float32)[:3, :4]
        pose[2, 3] = -4.0
        rng = np.random.RandomState(SEED + 17)
        ys, xs = rng.randint(0, H, args.N_rand), rng.randint(0, W, args.N_rand)
        ro, rd = pinhole_get_rays(H, W, NERF_FOCAL, torch.from_numpy(pose))
        ro, rd = ro[ys, xs], rd[ys, xs]
        vd = rd / rd.norm(dim=-1, keepdim=True)
        nr = args.N_rand
        rays = torch.cat([ro, rd, torch.full((nr, 1), 2.0), torch.full((nr, 1), 6.0), vd],
                         -1).to(dev)
        tgt = torch.from_numpy(target[ys, xs]).to(dev)

        def make():
            rk, _, _, nets, opt = trainer.create_nerf(args, device=dev)
            return rk['network_query_fn'], nets, opt

        def plain_loss(nets, nq, r, tg):
            o = render_rays(r, nets['coarse'], nq, args.N_samples,
                            N_importance=args.N_importance, network_fine=nets['fine'],
                            white_bkgd=True)
            return img2mse(o['rgb_map'], tg) + img2mse(o['rgb0'], tg)

        nq, nets_u, opt_u = make()
        _, nets_s, opt_s = make()
        step = make_sharded_nerf_step(opt_s, nq, mesh, N_samples=args.N_samples,
                                      N_importance=args.N_importance, white_bkgd=True)
        losses = []
        for _ in range(3):
            loss_u = plain_loss(nets_u, nq, rays, tgt)
            opt_u.zero_grad()
            loss_u.backward()
            opt_u.step()
            loss_s = step(nets_s, rays, tgt)
            losses.append((float(loss_u), float(loss_s)))
        torch.cuda.synchronize()
        same = all(a == b for a, b in losses) and all(
            torch.equal(a, b) for a, b in zip(nets_u.parameters(), nets_s.parameters()))
        if not same:
            raise AssertionError(f'phase 17d: the sharded step differs from the unsharded one: '
                                 f'{losses}')
        # two data shares emulated: their gradients summed against the whole batch's
        half = nr // 2
        grads = []
        for sl in (slice(0, nr), slice(0, half), slice(half, nr)):
            opt_u.zero_grad()
            plain_loss(nets_u, nq, rays[sl], tgt[sl]).backward()
            grads.append(torch.cat([q.grad.reshape(-1) for q in nets_u.parameters()]))
        e_share = ((grads[1] + grads[2]) / 2 - grads[0]).abs().max() / grads[0].abs().max()
        if not e_share.item() <= NERF_SHARE_TOL:
            raise AssertionError(f'phase 17d: two shares\' gradients {e_share.item():.3g} of max '
                                 f'from the whole batch\'s')
        for _ in range(3):
            step(nets_s, rays, tgt)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ms = []
        for _ in range(10):
            ev[0].record()
            step(nets_s, rays, tgt)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        out['nerf'] = {'losses': losses, 'share_err': e_share.item(),
                       'ms_per_step': float(np.median(ms)), 'ms_per_step_16b': h['nerf_ms']}
        log(f'  3 steps bit-equal to the unsharded step (losses {losses}); two shares\' '
            f'gradients summed {e_share.item():.3g} of max from the whole batch\'s; '
            f'{np.median(ms):.4f} ms a step (median of 10, CUDA events; phase 16b\'s '
            f'no-batching step {h["nerf_ms"]} ms, with its pixel choice and draws)  [{smi}]')
    finally:
        dist.destroy_process_group()
    out['seconds'] = time.time() - t_phase
    log(f'phase 17: {out["seconds"]:.1f} s')
    return out


# ---- phase 18: the Hopper probes of the TPU tools -------------------------------------

def load_tool(repo: Path, name: str):
    """The module ``tools/<name>.py`` of the checkout (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(f'tool_{name}', repo / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_phase(h):
    """Phase 18: T1 and T2 against their plain versions and timed, T3's
    stages of the px_f backward.  ``h``: repo, smi, reps.  Returns its
    numbers; raises on a difference (the tools' checks)."""
    repo, smi, reps = h['repo'], h['smi'], h['reps']
    from jrender_tpu_torch.probes import bwd_dma, micro
    t_phase = time.time()
    T1, T2, T3 = (load_tool(repo, n) for n in ('exp_torch_micro', 'exp_torch_bwd_dma',
                                               'profile_torch_bwd'))
    # ---- a. T1 ------------------------------------------------------------------------
    log(f'phase 18a: T1, tools/exp_micro.py\'s cases on {micro.N} steps of [16, 128] blocks, '
        'the products in both builds: without products bit-equal to the plain version (which '
        'one pair op fewer moves), with products within rtol 1e-5')
    r1 = T1.measure(reps=reps)
    log(f'  {r1["tail"]["case"]} (the chain\'s unrolled tail): bit-equal, checked only')
    for name, c in r1['cases'].items():
        log(f'  {name:18s}: {c["device_ms"]:.4f} ms ({c["us_per_step"]:.4f} us/step; step '
            f'{c["step_ms"]:.4f} + sum {c["sum_ms"]:.4f}), wrapper {c["ms"]:.4f}, plain '
            f'{c["plain_ms"]:.4f}, bound {c["bound_ms"]:.4f} by {c["bound_by"]}; rel err '
            f'{c["max_rel_err"]:.2g}  [{smi}]')
    for k, f in r1['fit'].items():
        log(f'  fit {k} ({", ".join(f["cases"])}): fixed {f["fixed_us_per_step"]:.4f} us a step '
            f'on the card ({f["fixed_us_per_block"]:.3f} us a block, {f["resident_blocks"]} '
            f'resident), {f["ns_per_pair_op"] * 1e3:.4f} ps a pair op '
            f'({f["pair_ops_per_s"]} pair ops/s)')
    for k, d in r1['dots'].items():
        log(f'  a [4, 128] x [128, 1024] product, {k}: +{d["us_per_dot_per_step"]:.4f} us a step '
            'on the card over pair20')
    log(f'  occupancy: {r1["occupancy"]}')
    # ---- b. T2 ------------------------------------------------------------------------
    log(f'phase 18b: T2, tools/exp_bwd_dma.py\'s variants on {bwd_dma.N} items, against the '
        'plain version (rtol 1e-5, checksums equal)')
    r2 = T2.measure(reps=reps)
    for name, c in r2['variants'].items():
        log(f'  {name:10s}: {c["device_ms"]:.4f} ms ({c["us_per_item"]:.4f} us/item), wrapper '
            f'{c["ms"]:.4f}, plain {c["plain_ms"]:.4f}, bound {c["bound_ms"]:.4f} by '
            f'{c["bound_by"]} ({c["bytes_once"]} B once, {c["bytes_copied"]} B as copied: '
            f'{c["copied_gb_per_s"]:.1f} GB/s); rel err {c["max_rel_err"]:.2g}  [{smi}]')
    for v in r2['undefined']:
        log(f'  {v:10s}: not defined by the reference (the TPU probe does not trace it)')
    for k, st in r2['staging'].items():
        log(f'  staging {k} ({st["route"]}, {st["rows_per_item"]} rows an item): '
            f'{st["us_per_item"]:.4f} us an item over base, {st["row_gb_per_s"]} GB/s of rows')
    log(f'  occupancy: {r2["occupancy"]}')
    # ---- c. T3 ------------------------------------------------------------------------
    log('phase 18c: T3, the px_f backward by stage at 1024 px (T = 25, K = 16): K6\'s rows '
        'bit-equal to the step\'s own K6 launch, the stages\' backward to pxf_impl.backward\'s '
        '(tools/profile_torch_bwd.py in a process of its own)')
    # in this process, after phases 3-17, the profiler's traces lost device
    # activity (fences and kernels), which device_total refuses
    res = subprocess.run([sys.executable, str(repo / 'tools' / 'profile_torch_bwd.py'),
                          '--reps', str(reps)], capture_output=True, text=True, timeout=600,
                         cwd=repo)
    if res.returncode:
        raise AssertionError(f'T3: tools/profile_torch_bwd.py exited {res.returncode}: '
                             f'{res.stderr[-4000:]}')
    r3 = {}
    for line in res.stdout.splitlines():
        name, _, rest = line.partition(' ')
        if name in T3.SPHERES and rest.startswith('{'):
            r3[name] = json.loads(rest)
    if set(r3) != set(T3.SPHERES):
        raise AssertionError(f'T3: tools/profile_torch_bwd.py printed {sorted(r3)}')
    for name, r in r3.items():
        log(f'  {name}: {r["F"]} faces, {r["items"]} work items, {r["entries"]} entries')
        for k in ('prep', 'fwd_thr', 'k6', 'face_sum', 'backward', 'step'):
            st = r[k]
            log(f'    {k:9s}: device {st["device_ms"]:.4f} ms, host {st["host_ms"]:.4f} ms '
                f'(events), kernels {st["kernels"]:g} + copies {st["copies"]:g} a call, '
                f'wrappers {st["wrapper_launches"]}'
                + (f', K6 kernel {st["kernel_device_ms"]:.4f} ms' if k == 'k6' else '')
                + (f', host synchronisations {st["syncs"]}' if k == 'step' else ''))
        log(f'    the step\'s largest kernels, ms: {r["step"]["by_kernel"]}  [{smi}]')
    out = {'T1': r1, 'T2': r2, 'T3': r3, 'seconds': time.time() - t_phase}
    log(f'phase 18: {out["seconds"]:.1f} s')
    return out


def probe_entries(p18, main_launches):
    """The probes' entries of the kernels line: their headline case (T1's
    pair20_dot25, T2's dots) beside every case's numbers; ``launches`` is
    their count on the main path (phases 3-17), ``probe_launches`` phase
    18's."""
    r1, r2 = p18['T1'], p18['T2']
    c1, c2 = r1['cases']['pair20_dot25'], r2['variants']['dots']
    keys = ('device_ms', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_rel_err')
    return [
        {'name': 'probe_micro', 'route': 'cuda', 'source': 'jrender_tpu_torch/csrc/probe_micro.cu',
         'replaces': 'tools/exp_micro.py:63', 'launches': main_launches['probe_micro'],
         'main_path': False, 'probe_launches': r1['launches'], 'case': 'pair20_dot25',
         'max_abs_err': max(c['max_abs_err'] for c in r1['cases'].values()),
         'ms': c1['ms'], 'device_ms': c1['device_ms'], 'plain_ms': c1['plain_ms'],
         'plain_on': 'all steps (each step\'s face row once)', 'bound_ms': c1['bound_ms'],
         'bound_by': c1['bound_by'], 'library_ms': None,
         'cases': {n: {k: c[k] for k in keys} for n, c in r1['cases'].items()},
         'fit': r1['fit'], 'dots': r1['dots']},
        {'name': 'probe_bwd_dma', 'route': 'cuda',
         'source': 'jrender_tpu_torch/csrc/probe_bwd_dma.cu',
         'replaces': 'tools/exp_bwd_dma.py:99', 'launches': main_launches['probe_bwd_dma'],
         'main_path': False, 'probe_launches': r2['launches'], 'case': 'dots',
         'max_abs_err': max(c['max_abs_err'] for c in r2['variants'].values()),
         'ms': c2['ms'], 'device_ms': c2['device_ms'], 'plain_ms': c2['plain_ms'],
         'plain_on': 'all items', 'bound_ms': c2['bound_ms'], 'bound_by': c2['bound_by'],
         'library_ms': None,
         'cases': {n: {k: c[k] for k in keys} for n, c in r2['variants'].items()},
         'staging': r2['staging']},
    ]


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
    from jrender_tpu_torch.probes import bwd_dma, micro
    from jrender_tpu_torch.transform import look_at, perspective
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.structures import vertex_normals_fn
    from jrender_tpu_torch.utils.checks import (fold_ties, grad_beyond, grad_unexplained,
                                                tie_soup, tie_symmetric)
    from jrender_tpu_torch.utils.device_time import device_ms
    from jrender_tpu_torch.utils.primitives import uv_sphere

    dev = torch.device('cuda')
    kernels_src = sorted(p.stem for p in (repo / 'jrender_tpu_torch' / 'csrc').glob('*.cu'))
    wrappers = {'softras_fwd': cuda_impl.launch, 'softras_thr': cuda_impl.launch_thr,
                'softras_bwd': cuda_impl.launch_bwd,
                'softras_bwd_reduce': cuda_impl.launch_reduce}

    dir_wrappers = {'softras_dir_prep': dir_impl.launch_dir_prep,
                    'softras_dir_fwd': dir_impl.launch_dir_fwd,
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

    # the probes of phase 18, which no entry point calls: zeroed once before
    # phase 3 (``zero_counts`` leaves them), read before phase 18
    probe_wrappers = {'probe_micro': micro.launch_micro, 'probe_bwd_dma': bwd_dma.launch_bwd_dma}

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

    # each wrapper's kernels (the names of their __global__ functions), whose
    # own device time per launch the kernels line reports as device_ms: read
    # with torch.profiler over the steps each route's phase runs
    dev_ms = {}
    binned_kernels = {'softras_fwd': ('softras_fwd_kernel',),
                      'softras_thr': ('softras_thr_kernel',),
                      'softras_bwd': ('softras_bwd_kernel', 'softras_bwd_big_kernel'),
                      'softras_bwd_reduce': ('softras_bwd_reduce_kernel',)}
    n3mr_kernels = {'n3mr_maps': ('n3mr_maps_kernel',), 'n3mr_texbwd': ('n3mr_texbwd_kernel',),
                    'n3mr_edge_bands': ('n3mr_edge_bands_kernel',),
                    'n3mr_edgebwd': ('n3mr_edgebwd_band_kernel', 'n3mr_edgebwd_global_kernel',
                                     'n3mr_edgebwd_sum_kernel')}
    dir_kernels = {k: (f'{k}_kernel',) for k in dir_wrappers}
    pxg_kernels = {'softras_pxg_fwd': ('softras_pxg_fwd_kernel',),
                   'softras_pxg_combine': ('softras_pxg_combine_kernel',),
                   'softras_pxg_thr': ('softras_pxg_thr_lists_kernel',
                                       'softras_pxg_thr_bisect_kernel'),
                   'softras_pxg_bwd': ('softras_tile_bwd_kernel',),
                   'segment_sum': ('segment_sum_kernel',)}

    def tiled_kernels(r):
        return {f'softras_{r}_fwd': ('softras_tile_fwd_kernel',),
                f'softras_{r}_bwd': ('softras_tile_bwd_kernel',)}

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
    # with the binned forward, threshold and backward built at the other
    # blocks per tile
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    variants = [(k, ((m, S),)) for k, m, chosen in (
        ('softras_fwd', 'SOFTRAS_FWD_SPLIT', cuda_impl.FWD_SPLIT),
        ('softras_thr', 'SOFTRAS_FWD_SPLIT', cuda_impl.FWD_SPLIT),
        ('softras_bwd', 'SOFTRAS_BWD_SPLIT', cuda_impl.BWD_SPLIT),
        ('softras_fpx_fwd', 'SOFTRAS_TILE_SPLIT', tiled.TILE_SPLIT),
        ('softras_pxf_fwd', 'SOFTRAS_TILE_SPLIT', tiled.TILE_SPLIT)) for S in SPLITS if S != chosen]
    variants += [('softras_pxg_fwd', pxg_impl.fwd_defines(b)) for b in pxg_impl.FWD_CAPS]
    variants += [('softras_pxg_bwd', tiled.bwd_defines(b)) for b in pxg_impl.BWD_BUILDS]
    variants += [('n3mr_maps', ncuda.maps_defines(b)) for b in ncuda.MAPS_BUILDS]
    variants += [('softras_pxg_thr', pxg_impl.thr_defines(b)) for b in pxg_impl.THR_BUILDS]
    # the probes' other builds of their products (phase 18)
    variants += [(micro.SOURCE, micro.FFMA_DEFINES)] + [
        (bwd_dma.SOURCE, bwd_dma.dot_defines(d)) for d in bwd_dma.DOTS if d != 'mma']
    _build.build(kernels_src + variants)
    log(f'build: {kernels_src} and {len(variants)} variants in {time.time() - t0:.1f} s')
    # the f_px and px_f forwards' variants too (registers and spills per
    # blocks per tile); the probes' registers come from their occupancy
    # queries in phase 18
    for name, defs in [(n, ()) for n in kernels_src if n not in (micro.SOURCE, bwd_dma.SOURCE)] + [
            v for v in variants if v[0] in ('softras_fpx_fwd', 'softras_pxf_fwd')]:
        if defs:
            log(f'  {name} built with {defs}:')
        # ptxas -v: per compiled function, its spills, then its registers
        # and static shared memory (the kernels' shared memory is dynamic)
        fn = spill = ''
        for line in _build.build_log(name, defs).splitlines():
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

    def thr_alone(pin, depths, cnt, p, tile=None):
        """The pxg threshold kernel (K8) alone, as a callable: its arguments
        made now (``pxg_impl.thr_args``), on every tile or on one tile; its
        launches are not counted."""
        args, thr = pxg_impl.thr_args(pin, depths, cnt, p, *(() if tile is None else (tile, 1)))
        fn = cuda_impl._entry('softras_pxg_thr', 'softras_pxg_thr', pxg_impl._PxgThrArgs)
        return lambda: (cuda_impl._run(fn, 'softras_pxg_thr', args, dev), thr)

    def textures(F, T, seed):
        gen.manual_seed(seed)
        return torch.rand((1, F, T, 3), generator=gen, device=dev)

    def sphere_faces(rings, segs, eye=(0.0, 0.0, -2.732)):
        v, f = uv_sphere(rings, segs)
        vt = perspective(look_at(torch.tensor(v, device=dev)[None], eye), angle=30)
        return face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9)

    def soup(F, B, T, seed, radius=(0.02, 0.25), centre=(-0.8, 0.8)):
        rng = np.random.RandomState(seed)
        c = rng.uniform(*centre, (B, F, 1, 2))
        r = rng.uniform(*radius, (B, F, 1, 1))
        ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
            + rng.uniform(-0.3, 0.3, (B, F, 3))
        xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
        z = 2.5 + rng.uniform(-0.4, 0.4, (B, F, 3, 1))
        fv = np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9)
        tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
        return torch.tensor(fv, device=dev), torch.tensor(tex, device=dev)

    def compare(tag, fv, tex, p, mt=None, exact=False):
        """The forward kernel twice (bit-equal) and against the plain
        version; ``mt``: the binning's emit cap; ``exact``: counts and hard
        winners must equal the plain version's on every pixel.  Returns the
        max abs error and the kernel's outputs."""
        inputs = cuda_impl.prepare(fv, tex, p)
        if mt is not None:
            inputs = inputs._replace(lists=binning.build_tile_lists_compact(
                fv, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt))
        img, ag, cnt = out = cuda_impl.launch(inputs, p)
        again = cuda_impl.launch(inputs, p)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f'{tag}: two runs of the forward differ in their bits')
        want, ag_w, cnt_w = torch_impl.soft_rasterize_fwd_plain(fv, tex, p, chunk_pairs=1 << 24)
        f_rgb, e_rgb = beyond(img[:, :3], want[:, :3], TOL, pixel_dim=1)
        f_a, e_a = beyond(img[:, 3], want[:, 3], TOL)
        f_c, _ = beyond(cnt.float(), cnt_w.float(), 0)
        check(f'{tag} rgb', f_rgb)
        check(f'{tag} alpha', f_a)
        check(f'{tag} count', f_c, 0.0 if exact else EDGE_FRAC)
        f_id = 0.0
        if p.aggr_func_rgb == 'hard':
            f_id, _ = beyond(ag[:, 1], ag_w[:, 1], 0)
            check(f'{tag} face index', f_id, 0.0 if exact else EDGE_FRAC)
        if not torch.isfinite(img).all():
            raise AssertionError(f'{tag}: non-finite output')
        cl = inputs.lists
        log(f'  {tag}: rgb {f_rgb:.4f} beyond (max {e_rgb:.3g}), alpha {f_a:.4f} '
            f'(max {e_a:.3g}), count {f_c:.4f}, face index {f_id:.4f}; longest list '
            f'{int(cl.gcount.max()) + int(cl.run_counts.max())} ({int(cl.gcount.max())} '
            f'big), bit-equal twice')
        return max(e_rgb, e_a), out

    def compare_thr(tag, fv, tex, p, mt=None):
        """The threshold kernel twice (bit-equal), against topk_threshold on
        the whole image, and built with the other blocks per tile of SPLITS
        (the same map, bit for bit: the merge is exact); ``mt``: the
        binning's emit cap."""
        inputs = cuda_impl.prepare(fv, tex, p)
        if mt is not None:
            inputs = inputs._replace(lists=binning.build_tile_lists_compact(
                fv, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt))
        _, _, cnt = cuda_impl.launch(inputs, p)
        thr = cuda_impl.launch_thr(inputs, cnt, p)
        again = cuda_impl.launch_thr(inputs, cnt, p)
        for S in SPLITS:
            if S != cuda_impl.FWD_SPLIT:
                args, thr_s = cuda_impl.thr_args(inputs, cnt, p)
                cuda_impl._run(cuda_impl.split_variant('softras_thr', S), 'softras_thr', args, dev)
                torch.cuda.synchronize()
                if not torch.equal(thr, thr_s):
                    raise AssertionError(f'{tag}: the threshold at {S} blocks per tile differs')
        torch.cuda.synchronize()
        if not torch.equal(thr, again):
            raise AssertionError(f'{tag}: two runs of the threshold differ in their bits')
        want = torch_impl.topk_threshold_plain(fv, p, chunk_pairs=1 << 24)
        bad = (thr - want).abs() > THR_RTOL * want.abs()
        check(f'{tag} threshold', bad.float().mean().item(), THR_FRAC)
        K = p.max_faces_id
        if not (thr[cnt <= K] == p.far).all():
            raise AssertionError(f'{tag}: a pixel with at most K candidates has a threshold')
        cl = inputs.lists
        log(f'  {tag}: K={K}, {(cnt > K).float().mean().item():.3f} of pixels over K, '
            f'{bad.float().mean().item():.6f} beyond (max {(thr - want).abs().max().item():.3g}); '
            f'longest list {int(cl.gcount.max()) + int(cl.run_counts.max())} '
            f'({int(cl.gcount.max())} big); bit-equal twice and at {SPLITS} blocks per tile')
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
        # the reduction alone against its plain version, on the same rows: the
        # plain version adds each face's rows in the kernel's order, bit for bit
        rf, rt = cuda_impl.reduce_rows_plain(inputs, rows, p)
        e_red = max((gf - rf).abs().max().item(), (gt - rt).abs().max().item())
        if not (torch.equal(gf, rf) and torch.equal(gt, rt)):
            raise AssertionError(f'{tag}: the reduction differs from its plain version '
                                 f'(max {e_red:.3g})')
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
            f'{f_t:.6f} (max {e_t:.2g}), reduction bit-equal to its plain version, big faces '
            f'{big} (none beyond), bit-equal twice')
        return max(e_f, e_t), e_red

    # ---- 3. kernels vs plain, whole images -------------------------------
    for w in probe_wrappers.values():
        w.launches = 0
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
    # the split of a tile's list over the cluster's FWD_SPLIT blocks: lists of
    # many chunks a rank (a dense soup at 128 px), big faces whose prefix of
    # the list spans several ranks (emit cap 2), a sparse soup whose lists
    # rank 0 walks alone, and twins at equal depth in different shares; counts
    # and winners exact
    fv_long, tex_long = soup(3000, 1, 4, SEED + 10, radius=(0.02, 0.08), centre=(-0.3, 0.3))
    for dist, rgb, alpha in configs:
        compare(f'long lists 128 {dist}/{rgb}/{alpha}', fv_long, tex_long,
                make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                            aggr_func_alpha=alpha, sigma_val=1e-4), exact=True)
    for rgb in ('hard', 'softmax'):
        compare(f'long lists 128 {rgb}, big faces (emit cap 2)', fv_long, tex_long,
                make_params(image_size=128, aggr_func_rgb=rgb, sigma_val=1e-4), mt=2, exact=True)
    fv, tex = soup(24, 2, 4, SEED + 11, radius=(0.01, 0.03))
    compare('sparse soup 128, most lists of one face', fv, tex, make_params(image_size=128),
            exact=True)
    # 18 x 18 texels a face: the staged rows pass 48 KB of shared memory
    fv_big_t, tex_big_t = soup(400, 1, 324, SEED + 13)
    compare('soup 128 T=324, rows past 48 KB', fv_big_t, tex_big_t,
            make_params(image_size=128, sigma_val=1e-4), exact=True)
    fv, tex = soup(1500, 1, 4, SEED + 12, radius=(0.02, 0.08), centre=(-0.3, 0.3))
    fv_twin, tex_twin = torch.cat([fv, fv], 1), torch.cat([tex, tex.flip(-1)], 1)
    for mt in (None, 2):
        _, (_, ag_t, _) = compare(f'twins 128 hard, emit cap {mt}', fv_twin, tex_twin,
                                  make_params(image_size=128, aggr_func_rgb='hard',
                                              sigma_val=1e-4), mt=mt, exact=True)
        won = ag_t[:, 1]
        if not (won >= 0).any() or (won >= 1500).any():
            raise AssertionError(f'twins, emit cap {mt}: a tie went to the higher id')

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
    # the split of a tile's list over the cluster's FWD_SPLIT blocks: lists of
    # many chunks a rank (K = 40: the ranks' bisection counts summed), big
    # faces whose prefix of the list spans several ranks (emit cap 2), twins
    # at equal depth in different shares (each depth counts twice), a sparse
    # soup whose lists rank 0 walks alone, the busiest tile's faces alone
    for K in (1, 4, 16, 40):
        for dist in ('hard', 'barycentric', 'euclidean'):
            thr_err = max(thr_err, compare_thr(
                f'long lists 128 {dist}', fv_long, tex_long,
                make_params(image_size=128, dist_func=dist, sigma_val=1e-4,
                            max_faces_per_pixel_for_grad=K)))
    for K in (4, 40):
        thr_err = max(thr_err, compare_thr(
            'long lists 128, big faces (emit cap 2)', fv_long, tex_long,
            make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=K), mt=2))
    fv, tex = soup(1500, 1, 4, SEED + 12, radius=(0.02, 0.08), centre=(-0.3, 0.3))
    for K in (1, 3):
        thr_err = max(thr_err, compare_thr(
            f'twins 128, equal depths', torch.cat([fv, fv], 1), torch.cat([tex, tex], 1),
            make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=K)))
    fv, tex = soup(60, 2, 1, SEED + 11, radius=(0.01, 0.2))
    thr_err = max(thr_err, compare_thr('sparse soup 128, lists of one face', fv, tex,
                                       make_params(image_size=128,
                                                   max_faces_per_pixel_for_grad=1)))
    cl_long = cuda_impl.prepare(fv_long, tex_long, make_params(image_size=128)).lists
    ids_long = binning.tile_list(cl_long, 0, int(cl_long.counts[0].argmax()),
                                 -(-128 // cuda_impl.TILE)).long()
    thr_err = max(thr_err, compare_thr(
        f'the busiest tile of the long lists alone ({ids_long.numel()} faces)',
        fv_long[:, ids_long].contiguous(), tex_long[:, ids_long].contiguous(),
        make_params(image_size=128, sigma_val=1e-4)))

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
    run_bwd('soup 128 T=324, rows past 48 KB', fv_big_t, tex_big_t,
            make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3))
    # the reduction's instances with big faces and B = 2: T = 1 (12 columns,
    # eight faces a warp), T = 4 (21, scalar columns), T = 9 (36, float4,
    # two faces a warp), T = 25 (84, float4, a warp a face)
    for T in (1, 4, 9, 25):
        fv, tex = soup(400, 2, T, SEED + 50 + T)
        run_bwd(f'soup 128 B=2 T={T} big faces', fv, tex,
                make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3), mt=4)
    # runs of many chunks for each of the backward's BWD_SPLIT ranks, and
    # with an emit cap of 2 tiles most faces big
    for mt in (None, 2):
        run_bwd(f'long runs 128, emit cap {mt}', fv_long, tex_long,
                make_params(image_size=128, sigma_val=1e-4, gamma_val=1e-3), mt=mt)

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
    dev_ms.update(device_ms(bench_step, binned_kernels, reps=STEPS))
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
        f'{bwd_ms:.4f} ms, reduction {red_ms:.4f} ms (wrappers, CUDA events); device time '
        f'in the step: {({k: dev_ms[k] for k in binned_kernels})}  [{smi}]')
    log(f'  plain versions on {some}: forward {fwd_plain_ms:.1f} ms, '
        f'threshold {thr_plain_ms:.1f} ms, backward {bwd_plain_ms:.1f} ms; reduction (all rows) '
        f'{red_plain_ms:.3f} ms, index_add_ {red_lib_ms:.3f} ms  [{smi}]')
    log(f'  render_mesh forward {render_ms:.3f} ms/frame; soft_rasterize fwd+bwd step '
        f'{step_ms:.3f} ms; render_mesh fwd+bwd step {render_step_ms:.3f} ms  [{smi}]')

    # the split of a tile's list: each kernel on the faces of the busiest tile
    # alone (before the split that tile's one block was the kernel's tail),
    # and the kernels built with the other numbers of blocks per tile
    # (cuda_impl.split_variant), on the same inputs
    busy = int(cl.counts[0].argmax())
    ids_b = binning.tile_list(cl, 0, busy, -(-1024 // cuda_impl.TILE)).long()
    in_busy = cuda_impl.prepare(fv_full[:, ids_b].contiguous(), tex_full[:, ids_b].contiguous(),
                                p_full, for_grad=True)
    img_b, ag_b, cnt_b = cuda_impl.launch(in_busy, p_full)
    thr_b = cuda_impl.launch_thr(in_busy, cnt_b, p_full)
    cases = {'frame': (inputs, img_f, ag_f, thr_f, g_ones, counts_full),
             'busiest tile': (in_busy, img_b, ag_b, thr_b, torch.ones_like(img_b), cnt_b)}
    split_ms = {}
    split_kernels = (('softras_fwd', cuda_impl.FWD_SPLIT), ('softras_thr', cuda_impl.FWD_SPLIT),
                     ('softras_bwd', cuda_impl.BWD_SPLIT))
    for kernel, chosen in split_kernels:
        for S in SPLITS:
            fn = None if S == chosen else cuda_impl.split_variant(kernel, S)
            for which, (inp, im, ag_, th, g_, cn) in cases.items():
                if kernel == 'softras_fwd':
                    args = cuda_impl.fwd_args(inp, p_full)[0]
                    run = (lambda: cuda_impl.launch(inp, p_full)) if fn is None else \
                        (lambda: cuda_impl._run(fn, kernel, args, dev))
                elif kernel == 'softras_thr':
                    args, th_s = cuda_impl.thr_args(inp, cn, p_full)
                    run = (lambda: cuda_impl.launch_thr(inp, cn, p_full)) if fn is None else \
                        (lambda: cuda_impl._run(fn, kernel, args, dev))
                    if fn is not None:
                        run()
                        torch.cuda.synchronize()
                        if not torch.equal(th_s, th):
                            raise AssertionError(f'1024 px {which}: the threshold at {S} blocks '
                                                 'per tile differs')
                else:
                    args = cuda_impl.bwd_args(inp, im, ag_, th, g_, p_full)[0]
                    run = (lambda: cuda_impl.launch_bwd(inp, im, ag_, th, g_, p_full)) \
                        if fn is None else (lambda: cuda_impl._run(fn, kernel, args, dev))
                split_ms[kernel, S, which] = timed(run, reps=30)
    fwd_busy_ms = split_ms['softras_fwd', cuda_impl.FWD_SPLIT, 'busiest tile']
    thr_busy_ms = split_ms['softras_thr', cuda_impl.FWD_SPLIT, 'busiest tile']
    bwd_busy_ms = split_ms['softras_bwd', cuda_impl.BWD_SPLIT, 'busiest tile']
    # the threshold alone, on the inputs of the bench step, and its busiest
    # tile alone, with the chosen build; and at K = 40, past the per-thread
    # list: the bisection's 32 walks (the count map does not depend on K)
    p_k40 = make_params(image_size=1024, max_faces_per_pixel_for_grad=40)
    thr_k40_ms = timed(lambda: cuda_impl.launch_thr(inputs, counts_full, p_k40), reps=3, warm=1)
    log(f'  threshold: frame {thr_ms:.4f} ms, busiest tile ({ids_b.numel()} faces) alone '
        f'{thr_busy_ms:.4f} ms; maps at {SPLITS} blocks per tile bit-equal; at K = 40 '
        f'(bisection) {thr_k40_ms:.4f} ms, {(counts_full > 40).float().mean().item():.4f} of '
        f'pixels over K  [{smi}]')
    for kernel, chosen in split_kernels:
        log(f'  {kernel}, blocks per tile (chosen {chosen}): ' + '; '.join(
            f'{S}: frame {split_ms[kernel, S, "frame"]:.4f} ms, busiest tile '
            f'({ids_b.numel()} faces) alone {split_ms[kernel, S, "busiest tile"]:.4f} ms'
            for S in SPLITS) + f'  [{smi}]')
    # their dynamic shared memory, as the launchers size it (registers and
    # spills: phase 2)
    reserved_b = cuda_impl.bwd_reserved_bytes(GC - 9)
    chunk_f = cuda_impl.staged_chunk(row)
    chunk_b = cuda_impl.staged_chunk(row, reserved_b)
    chunk_t = cuda_impl.thr_chunk(p_full.max_faces_id)
    log(f'  shared memory a block: softras_fwd {max(8 * chunk_f * (row + 1), 4 * 7 * 256):,} '
        f'bytes ({chunk_f} faces a chunk, 2 buffers), softras_thr '
        f'{8 * chunk_t * (cuda_impl.ROW_BASE + 1) + 4 * (p_full.max_faces_id + 1) * 256:,} bytes '
        f'({chunk_t} faces a chunk, 2 buffers, K = {p_full.max_faces_id} depths a pixel), '
        f'softras_bwd {8 * chunk_b * (row + 1) + reserved_b:,} bytes ({chunk_b} faces a chunk, '
        '2 buffers)')

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
    fwd_err = max(fwd_err, compare(tag, fv_t, tex_t, p_t)[0])
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
    from jrender_tpu_torch.ops.n3mr import torch_impl as nplain, rasterize
    from jrender_tpu_torch.ops.n3mr.api import fill_back_faces, fill_back_textures
    from jrender_tpu_torch.utils.checks import (N3MR_SUM_TOL, n3mr_maps_beyond,
                                                n3mr_special_faces, scaled_err)
    n_wrappers = {'n3mr_maps': ncuda.launch_maps, 'n3mr_texbwd': ncuda.launch_texbwd,
                  'n3mr_edge_bands': ncuda.launch_edge_bands,
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

    def band_keys_check(tag, pp, is_):
        """The band-key kernel against its plain version on pp: keys and
        items must be equal; the largest difference goes to n_err."""
        keys, items = ncuda.launch_edge_bands(pp, is_)
        keys_w, items_w = ncuda.band_keys_plain(pp, is_)
        torch.cuda.synchronize()
        if keys.dtype != keys_w.dtype or keys.shape != keys_w.shape \
                or items.shape != items_w.shape:
            raise AssertionError(f'{tag}: the band keys differ from the plain version\'s in '
                                 'type or shape')
        e = max((keys - keys_w).abs().max().item() if keys.numel() else 0,
                (items - items_w).abs().max().item() if items.numel() else 0)
        n_err['n3mr_edge_bands'] = max(n_err['n3mr_edge_bands'], float(e))
        if e != 0:
            raise AssertionError(f'{tag}: the band keys differ from the plain version\'s '
                                 f'by up to {e}')
        return keys, items

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
        # the band keys: the kernel's equal the plain version's, bit for bit
        pp = ncuda.edge_inputs(face, fi, rgb, alpha, gr, ga, is_, True, True)[0]
        nb = band_keys_check(tag, pp, is_)[1][:, 2]
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
            f'covered {alpha.mean().item():.3f}; edge items in bands {int((nb > 0).sum())}, '
            f'global {int((nb < 0).sum())}, band keys equal; bit-equal twice')
        return int((nb < 0).sum())

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
    # triangles over most of the screen: long silhouette edges, which span
    # more than EDGE_SPAN bands, take the global list
    fv_lg, _ = soup(40, 2, 1, SEED + 25, radius=(0.4, 0.9), centre=(-0.3, 0.3))
    if n3mr_compare('soup 128 long silhouette edges', fv_lg, n3mr_texture(2, 40, 2, SEED + 26),
                    128) < 20:
        raise AssertionError('long silhouette edges: too few edge items in the global list')
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
    # the texture gradient's instances: sums in registers (ts 1, 2, 4), in
    # shared memory in one walk (6) and in several (7, 9); on the screen-
    # filling, zero-area and NaN faces, B = 2, a 72-px image
    tex_errs = {}
    for ts in (1, 2, 4, 6, 7, 9):
        tex_k13 = n3mr_texture(2, 300, ts, SEED + 30 + ts)
        rows_k13, *maps_k13 = ncuda.forward_maps(fv_sp, tex_k13, 72, 0.1, 100.0, 1e-3)
        fi_k13, wt_k13, dp_k13, _, zc_k13, rgb_k13 = maps_k13
        gen.manual_seed(SEED + 40 + ts)
        gr_k13 = torch.randn(rgb_k13.shape, generator=gen, device=dev)
        in_k13 = (tex_k13.shape, fi_k13, wt_k13, dp_k13, zc_k13, gr_k13, 1e-3)
        g_k13 = twice(f'72 px ts={ts} texture gradient',
                      lambda: ncuda.backward_textures(rows_k13, *in_k13))
        e_k13 = scaled_err(g_k13, nplain.backward_textures(*in_k13))
        check(f'72 px ts={ts} texture gradient', e_k13, N3MR_SUM_TOL)
        if not (g_k13[:, 0].abs().max() > 0 and (g_k13[:, 1:3] == 0).all()):
            raise AssertionError(f'72 px ts={ts}: the screen-filling face has no texture '
                                 'gradient, or a degenerate face has one')
        n_err['n3mr_texbwd'] = max(n_err['n3mr_texbwd'], e_k13)
        tex_errs[ts] = e_k13
    log(f'  texture gradient at 72 px, B = 2, special faces, by texture size: {tex_errs} of '
        f'scale; bit-equal twice')

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
    if n_render_counts != {'n3mr_maps': FRAMES, 'n3mr_texbwd': 0, 'n3mr_edge_bands': 0,
                           'n3mr_edgebwd': 0}:
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
    dev_ms.update(device_ms(n3mr_step, n3mr_kernels, reps=STEPS))
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

    # the z-buffer on the busiest tile's cluster alone (a grid of that one
    # cluster, on the frame's lists; its launches are not counted): its
    # tiles' maps are the frame's, bit for bit; and every other build of
    # MAPS_BUILDS twice: the default build's maps, bit for bit
    busy_n = int(lists_n.counts[0].argmax())
    args_busy, maps_busy = ncuda.maps_args(rows_n, lists_n, tex_n, 1024, 0.1, 100.0, EPS_N,
                                           tile=busy_n)
    maps_fn = ncuda.maps_variant()
    cuda_impl._run(maps_fn, 'n3mr_maps', args_busy, dev)
    torch.cuda.synchronize()
    ty_b, tx_b = divmod(busy_n, -(-1024 // ncuda.TILE))
    ty_c = ty_b - ty_b % ncuda.MAPS_SPLIT
    on_busy = torch.zeros((1024, 1024), dtype=torch.bool, device=dev)
    on_busy[ty_c * 16:(ty_c + ncuda.MAPS_SPLIT) * 16, tx_b * 16:tx_b * 16 + 16] = True
    if not all(torch.equal(a[0][on_busy], b[0][on_busy]) for a, b in zip(maps_busy, maps_n)):
        raise AssertionError('1024 px: the busiest tile\'s cluster alone gives other maps there')
    busy_cluster_faces = int(lists_n.counts[0].reshape(-1, 1024 // 16)[
        ty_c:ty_c + ncuda.MAPS_SPLIT, tx_b].sum())
    for b in ncuda.MAPS_BUILDS:
        for _ in range(2):
            args_v, maps_v = ncuda.maps_args(rows_n, lists_n, tex_n, 1024, 0.1, 100.0, EPS_N)
            cuda_impl._run(ncuda.maps_variant(ncuda.maps_defines(b)), 'n3mr_maps', args_v, dev)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(maps_v, maps_n)):
                raise AssertionError(f'1024 px: z-buffer build {b} differs from the default')
    maps_occ = ncuda.maps_occupancy()
    log(f'  z-buffer builds {ncuda.MAPS_BUILDS} (twice each): bit-equal to the default build '
        f'{ncuda.MAPS_BUILD}; {maps_occ}')

    # timings: each kernel alone on the step's inputs, its plain version, and
    # for the texture gradient the one PyTorch call that sums the same rows
    maps_ms = timed(lambda: ncuda.launch_maps(rows_n, lists_n, tex_n, 1024, 0.1, 100.0, EPS_N))
    maps_busy_ms = timed(lambda: cuda_impl._run(maps_fn, 'n3mr_maps', args_busy, dev))
    texbwd_ms = timed(lambda: ncuda.launch_texbwd(rows_n, tex_n.shape, fi_n, wt_n, dp_n, zc_n,
                                                  gr_n, EPS_N))
    edgebwd_ms = timed(lambda: ncuda.launch_edgebwd(*edge_in, EPS_N, True, False))
    edge_prep_ms = timed(lambda: ncuda.edge_inputs(fv_n, fi_n, rgb_n, alpha_n, gr_n, alpha_n,
                                                   1024, True, False))
    # the band keys alone (kernel, and with their sort), held against their
    # plain version on the same inputs, bit for bit
    keys_n, items_n = band_keys_check('1024 px', edge_in[0], 1024)
    nb_n, key_bytes = items_n[:, 2], keys_n.element_size()
    bands_ms = timed(lambda: ncuda.launch_edge_bands(edge_in[0], 1024))
    bands_sort_ms = timed(lambda: ncuda.edge_bands(edge_in[0], 1024))
    bands_plain_ms = timed(lambda: ncuda.band_keys_plain(edge_in[0], 1024))
    # the anti-aliased step's edge gradient: the maps at 2048 px
    rows_aa = nplain.face_rows(fv_n, 2048)
    maps_aa = ncuda.launch_maps(rows_aa, ncuda.tile_lists(fv_n, 2048), tex_n, 2048, 0.1, 100.0,
                                EPS_N)
    fi_aa, rgb_aa = maps_aa[0], maps_aa[5]
    gen.manual_seed(SEED + 9)
    gr_aa = torch.randn(rgb_aa.shape, generator=gen, device=dev)
    alpha_aa = (fi_aa >= 0).float()
    edge_aa = ncuda.edge_inputs(fv_n, fi_aa, rgb_aa, alpha_aa, gr_aa, alpha_aa, 2048, True, False)
    g_face_aa = twice('2048 px edge gradient', lambda: ncuda.launch_edgebwd(
        *edge_aa, EPS_N, True, False))
    e_aa = scaled_err(g_face_aa[:, ids_n], nplain.backward_pixel_map(
        fv_n, fi_aa, rgb_aa, alpha_aa, gr_aa, alpha_aa, 2048, EPS_N, True, False, faces=ids_n))
    check('2048 px edge gradient of the sampled faces', e_aa, N3MR_SUM_TOL)
    n_err['n3mr_edgebwd'] = max(n_err['n3mr_edgebwd'], e_aa)
    edgebwd_aa_ms = timed(lambda: ncuda.launch_edgebwd(*edge_aa, EPS_N, True, False))
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
    # the band design's bytes: each band's rows of both views (face index and
    # 6 channels) read once, pp, the sorted keys, their order and the items
    # read once (a key of key_bytes, its order of 8), the slots written and
    # read once, the gradient written
    n_items = 6 * F_n
    slot_bytes = 4 * 2 * int(nb_n.clamp_min(0).sum() + (nb_n < 0).sum())
    band_bytes = 4 * 2 * 7 * HW_n + 4 * 7 * F_n + (key_bytes + 8) * n_items * ncuda.EDGE_SPAN \
        + 12 * n_items + 2 * slot_bytes + 4 * 9 * F_n
    band_bytes_ms = band_bytes / PEAK_BYTES * 1e3
    # the band keys: pp in, the keys and items out
    bands_bound = bound(n_items * (ncuda.EDGE_SPAN * 6 + 12),
                        4 * 7 * F_n + key_bytes * n_items * ncuda.EDGE_SPAN + 12 * n_items)
    e_rows_aa, out_aa, in_aa, longest_aa, pos_aa = nplain.edge_scan_census(
        fv_n, fi_aa, 2048, [[(rgb_aa[0, ..., k], gr_aa[0, ..., k]) for k in range(3)]])
    edgebwd_aa_bound = bound(
        (out_aa + in_aa) * 3 * N_OPS_CHANNEL + pos_aa * N_OPS_CELL + e_rows_aa * 40,
        4 * (F_n * 6 + 7 * 4 * HW_n + F_n * 9))
    log(f'  counts: {int(front_n.sum().item())} front faces, {won.numel()} drawn; tile-list '
        f'pairs with a front face {front_pairs:,}, inside {inside_pairs:,}, drawn pixels '
        f'{drawn:,}; busiest tile {int(lists_n.counts.max().item())} faces; edge scans: '
        f'{e_rows:,} rows, {out_cells:,} cells outwards, {in_cells:,} inwards, '
        f'{pos_cells:,} with a positive difference, the longest item {longest:,} cells '
        f'({longest / max(out_cells + in_cells, 1):.2e} of all, mean item '
        f'{(out_cells + in_cells) / max(int(front_n.sum().item()) * 6, 1):,.0f})')
    for name, b in (('n3mr_maps', maps_bound), ('n3mr_texbwd', texbwd_bound),
                    ('n3mr_edge_bands', bands_bound), ('n3mr_edgebwd', edgebwd_bound),
                    ('n3mr_edgebwd at 2048 px', edgebwd_aa_bound)):
        log(f'  bound {name}: {b[0]:.6f} ms by {b[1]}: {b[2]}')
    log(f'  edge items: {int((nb_n > 0).sum()):,} in bands of {ncuda.EDGE_BAND} rows, '
        f'{int((nb_n < 0).sum()):,} global, {int(nb_n.clamp_min(0).sum()):,} (item, band) '
        f'slots; the band design moves {band_bytes:,} bytes ({band_bytes_ms:.6f} ms at the '
        f'HBM rate); at 2048 px: {e_rows_aa:,} rows, {out_aa:,} cells outwards, {in_aa:,} '
        f'inwards, {pos_aa:,} positive, longest item {longest_aa:,}')
    log(f'  kernels alone: z-buffer {maps_ms:.4f} ms (the busiest tile, {busy_n}, '
        f'{int(lists_n.counts[0, busy_n])} faces; its cluster of {ncuda.MAPS_SPLIT} tiles, '
        f'{busy_cluster_faces} faces, alone {maps_busy_ms:.4f} ms), '
        f'texture gradient {texbwd_ms:.4f} ms, '
        f'edge gradient {edgebwd_ms:.4f} ms with its band keys and their sort (the keys '
        f'{bands_ms:.4f} ms, with the sort {bands_sort_ms:.4f} ms, plain {bands_plain_ms:.4f} ms; '
        f'its inputs, plain torch: {edge_prep_ms:.4f} ms); at 2048 px {edgebwd_aa_ms:.4f} ms; '
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
                      'n3mr_edge_bands': 0, 'n3mr_edgebwd': 0}:
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
        table = dir_impl.prep_dir(fv, tex, p, for_grad=True)   # the prep kernel's items
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

    def dir_alone(tag, table, img, ag, thr, p):
        """K10 (with the threshold and without it) and K11 alone on a table
        prepared with its items: their times (CUDA events), K11's items, the
        bytes of its partial rows and the peak memory above the start of one
        call, both kernels bit-equal twice."""
        # the prep kernel on the table's bboxes, gathered by a permutation
        # (the inverse order), against its plain version to the bit
        ids_p = table.inv
        got_p = dir_impl.launch_dir_prep(table.bbox, ids_p, p.image_size, True)
        want_p = dir_impl.prep_plain(table.bbox, ids_p, p.image_size, True)
        if not (torch.equal(got_p[0], want_p[0]) and torch.equal(got_p[1], want_p[1])
                and all(torch.equal(x, y) for x, y in zip(got_p[2][:3], want_p[2][:3]))
                and dir_impl.item_count(got_p[2]) == dir_impl.item_count(want_p[2])):
            raise AssertionError(f'{tag}: the dir prep kernel differs from its plain version')
        B_, F_ = table.ids.shape
        U_ = -(-F_ // dir_impl.WINDOW)
        g = torch.ones_like(img)
        out = {'prep_kernel_ms': timed(lambda: dir_impl.launch_dir_prep(
                   table.bbox, ids_p, p.image_size, True), reps=30),
               'prep_plain_ms': timed(lambda: dir_impl.prep_plain(
                   table.bbox, ids_p, p.image_size, True), reps=5),
               # bboxes and ids in once; sorted bboxes, unions, offsets and
               # counters out once
               'prep_bound': bound(0, 4 * B_ * F_ * (4 + 1) + 4 * B_ * F_ * (4 + 1 + 1)
                                   + 4 * (4 * B_ * U_ + B_ * U_ + 1)),
               'fwd_ms': timed(lambda: dir_impl.launch_dir_fwd(table, p, True), reps=30),
               'fwd_nothr_ms': timed(lambda: dir_impl.launch_dir_fwd(table, p, False), reps=30),
               'bwd_ms': timed(lambda: dir_impl.launch_dir_bwd(table, img, ag, thr, g, p),
                               reps=30)}
        a = dir_impl.launch_dir_fwd(table, p, True)
        b = dir_impl.launch_dir_fwd(table, p, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        gf, gt = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        torch.cuda.synchronize()
        out['bwd_peak_bytes'] = torch.cuda.max_memory_allocated() - m0
        gf2, gt2 = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(a, b))
                and torch.equal(gf, gf2) and torch.equal(gt, gt2)):
            raise AssertionError(f'{tag}: two runs of a dir kernel differ in their bits')
        B, F = table.rows.shape[:2]
        items = dir_impl.item_count(table.items)
        live = dir_impl.bwd_items_plain(table.bbox, p.image_size)[0].numel()
        if items != live:
            raise AssertionError(f'{tag}: {items} backward items, the plain rule {live}')
        GC = cuda_impl._grad_columns(p, table.tex_res)
        out.update({'bwd_items': items, 'bwd_part_bytes': 4 * items * GC,
                    'bwd_first_design_warps': B * F * table.items.splits,
                    'bwd_first_design_part_bytes': 4 * B * F * table.items.splits * GC})
        log(f'  {tag} prep kernel {out["prep_kernel_ms"]:.4f} ms (plain '
            f'{out["prep_plain_ms"]:.4f}, bound {out["prep_bound"][0]:.6f} ms by '
            f'{out["prep_bound"][1]}), equal to its plain version  [{smi}]')
        log(f'  {tag} kernels alone: forward {out["fwd_ms"]:.4f} ms (without the threshold '
            f'{out["fwd_nothr_ms"]:.4f}), backward {out["bwd_ms"]:.4f} ms; the backward\'s '
            f'{items:,} items of {B * F:,} faces (the first design launched '
            f'{out["bwd_first_design_warps"]:,} warps), partial rows {out["bwd_part_bytes"]:,} '
            f'bytes (the first design {out["bwd_first_design_part_bytes"]:,}), peak '
            f'{out["bwd_peak_bytes"]:,} bytes above the start of one call; both bit-equal '
            f'twice  [{smi}]')
        return out

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
            if read_dir() != {'softras_dir_prep': FRAMES, 'softras_dir_fwd': FRAMES,
                              'softras_dir_bwd': 0} \
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
                waits = []
                for i in range(STEPS):
                    step(i)
                    waits.append(dir_impl.launch_dir_bwd.wait_ms)
                    want = dict.fromkeys(dir_wrappers, i + 1)
                    if read_dir() != want or any(read_counts().values()):
                        raise AssertionError(f'{tag} {name}: launches after step {i + 1}: '
                                             f'{read_dir()}, {read_counts()}')
                    no_pxg(f'phase 11b {tag} {name}')
                torch.cuda.synchronize()
                out[f'{name}_launches'] = read_dir()
                out[f'{name}_wait_ms'] = float(np.median(waits))
                if name == 'soft_rasterize':
                    out['device_ms'] = device_ms(raster_step, dir_kernels, reps=STEPS)
                for leaf in grads:
                    if leaf.grad is None or not (torch.isfinite(leaf.grad).all()
                                                 and leaf.grad.abs().max() > 0):
                        raise AssertionError(f'{tag} {name}: a gradient is missing, '
                                             f'non-finite or zero')

            # 4,096 pixels of the step's frame and their gradient
            p_m = make_params(image_size=1024)
            tex_s = tie_symmetric(tex_l)
            table = dir_impl.prep_dir(fv_m, tex_s, p_m, for_grad=True)
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
            out.update(dir_alone(tag, table, img, ag, thr, p_m))
            out['prep_ms'] = timed(lambda: dir_impl.prep_dir(fv_m, tex_s, p_m))
            out['prep_grad_ms'] = timed(lambda: dir_impl.prep_dir(fv_m, tex_s, p_m, True))
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
        log(f'  {tag}: prep {out["prep_ms"]:.4f} ms ({out["prep_grad_ms"]:.4f} with the '
            f'backward\'s items); plain on {out["plain_on"]}: forward '
            f'{out["fwd_plain_ms"]:.1f} ms, backward {out["bwd_plain_ms"]:.1f} ms; the '
            f'backward\'s wait on the item count in a step {out["soft_rasterize_wait_ms"]:.4f} ms '
            f'(render_mesh {out["render_mesh_wait_ms"]:.4f}, host clock)  [{smi}]')
        log(f'  {tag} in turns (binned, dir, dir, binned), ms: soft_rasterize step / '
            f'render_mesh step / render_mesh frame: {times}; medians binned {med["binned"]}, '
            f'dir {med["dir"]}  [{smi}]')
        return out

    small = dir_full_width('288 faces', 13, 12)
    dev_ms.update(small['device_ms'])
    dir_counts = small['soft_rasterize_launches']
    middle = dir_full_width('3,330 faces', 38, 45)
    # bench.py's headline sphere (phase 4's inputs) on the dir kernels alone
    table_l = dir_impl.prep_dir(fv_full, tex_sym, p_full, for_grad=True)
    img_l, ag_l, _, thr_l = dir_impl.launch_dir_fwd(table_l, p_full, True)
    large = dir_alone(f'{fv_full.shape[1]:,} faces', table_l, img_l, ag_l, thr_l, p_full)
    del table_l, img_l, ag_l, thr_l

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
    tab_t = dir_impl.prep_dir(fv_t, tex_ts, p_t, for_grad=True)
    img_t, ag_t, _, thr_t = dir_impl.launch_dir_fwd(tab_t, p_t, True)
    demo_d = dir_alone(f'demo 2, B={VIEWS}', tab_t, img_t, ag_t, thr_t, p_t)
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
                # the threshold kernel runs on every forward with a gradient,
                # over every tile (no host read picks the overfull ones)
                want = {n: i + 1 for n in pxg_wrappers}
                if read_pxg() != want or any(read_counts().values()) \
                        or any(read_dir().values()) or any(read_tiled().values()) \
                        or read_sum() != i + 1:
                    raise AssertionError(f'pxg {tag}: launches after step {i + 1}: '
                                         f'{read_pxg()}, {read_counts()}, {read_dir()}, face '
                                         f'sums {read_sum()}')
            torch.cuda.synchronize()
            return {**read_pxg(), 'segment_sum': read_sum()}

        pxg_counts = pxg_steps('soft_rasterize', lambda i: bench_step())
        dev_ms.update(device_ms(bench_step, pxg_kernels, reps=STEPS))
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
            raise AssertionError('1024 px: no overfull tile at K = 16: the threshold kernel '
                                 'merges nothing')

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
            'thr': timed(thr_alone(pin_f, depths_f, cnt_g, p_full), reps=30),
            'thr_wrapper': timed(lambda: pxg_impl.launch_pxg_thr(pin_f, depths_f, cnt_g, p_full),
                                 reps=30),
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
        # the threshold's yardstick: torch.kthvalue on the overfull tiles'
        # lists, already gathered ([tiles, items x K, 256]; the gather is not
        # timed)
        lists_o, ok_o = pxg_impl._by_tile(pin_f, depths_f, over_f.long())
        lists_o = torch.where(ok_o[:, :, None, None], lists_o, float('inf')).reshape(
            over_f.numel(), -1, pxg_impl.PIXELS)
        gm_lib['thr'] = timed(lambda: torch.kthvalue(lists_o, p_full.max_faces_id, dim=1),
                              reps=30)
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
            # lists and the count map in, the threshold map out
            'thr': bound(over_items * p_full.max_faces_id * pxg_impl.PIXELS * OPS_LIST,
                         4 * over_items * p_full.max_faces_id * pxg_impl.PIXELS
                         + 4 * 2 * B * HW),
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
            f'{gm["thr"]:.4f} (its wrapper {gm["thr_wrapper"]:.4f}), backward {gm["bwd"]:.4f}, '
            f'sum {gm["sum"]:.4f}  [{smi}]')
        log(f'  plain versions, ms: ' + ', '.join(f'{k} {v:.3f} on {gm_on[k]}'
                                                  for k, v in gm_plain.items())
            + f'; index_add_: combine {gm_lib["combine"]:.4f}, sum {gm_lib["sum"]:.4f}; '
            f'torch.kthvalue of the gathered lists {gm_lib["thr"]:.4f}  [{smi}]')
        mem = {'parts': part_bytes, 'depth lists': list_bytes, 'entry rows': 4 * E_f * GC}
        log(f'  scratch, bytes: {mem}')

        # K7 and K9 on the busiest tile's work items alone (the frame's
        # inputs), K9 at work items of 8 faces, and every other build of
        # both twice: each bit-equal to the default build on the frame
        depths_f = pxg_impl.launch_pxg_fwd(pin_f, p_full, True)[1]
        on_busy = pin_f.items[:, 0] == busiest
        pin_bf = pin_f._replace(items=pin_f.items[on_busy].contiguous())
        lo_b, hi_b = int(pin_f.tile_off[busiest]), int(pin_f.tile_off[busiest + 1])
        parts_bt, depths_bt = pxg_impl.launch_pxg_fwd(pin_bf, p_full, True)
        rows_bt = pxg_impl.launch_pxg_bwd(pin_bf, img_g, ag_g, thr_g, g_ones, p_full)
        pin_8 = pxg_impl.prep_pxg(fv_full, tex_full, p_full, for_grad=True, group=8)
        rows_8 = pxg_impl.launch_pxg_bwd(pin_8, img_g, ag_g, thr_g, g_ones, p_full)
        torch.cuda.synchronize()
        if not (torch.equal(parts_bt, parts_f[on_busy])
                and torch.equal(depths_bt, depths_f[on_busy])
                and torch.equal(rows_bt[lo_b:hi_b], grows_f[lo_b:hi_b])):
            raise AssertionError('pxg 1024 px: the busiest tile\'s items alone differ from the '
                                 'frame\'s')
        if not torch.equal(rows_8, grows_f):
            raise AssertionError('pxg 1024 px: K9\'s rows at work items of 8 faces differ')
        gm_busy = {
            'fwd': timed(lambda: pxg_impl.launch_pxg_fwd(pin_bf, p_full, True), reps=30),
            'fwd_nothr': timed(lambda: pxg_impl.launch_pxg_fwd(pin_bf, p_full, False), reps=30),
            'bwd': timed(lambda: pxg_impl.launch_pxg_bwd(pin_bf, img_g, ag_g, thr_g, g_ones,
                                                         p_full), reps=30)}
        bwd_8_ms = timed(lambda: pxg_impl.launch_pxg_bwd(pin_8, img_g, ag_g, thr_g, g_ones,
                                                         p_full), reps=30)
        view_f = pxg_impl.bwd_view(pin_f, p_full)
        for b in pxg_impl.FWD_CAPS:
            for lists in (True, True, False):
                args_v, (pv, dv) = pxg_impl.fwd_args(pin_f, p_full, lists)
                cuda_impl._run(pxg_impl.fwd_variant(pxg_impl.fwd_defines(b)), 'softras_pxg_fwd',
                               args_v, dev)
                torch.cuda.synchronize()
                if not torch.equal(pv, parts_f) or (lists and not torch.equal(dv, depths_f)):
                    raise AssertionError(f'pxg 1024 px: K7 at cap {b} (depth lists {lists}) '
                                         'differs from the default build')
        for b in pxg_impl.BWD_BUILDS:
            for _ in range(2):
                args_v, rv = tiled.bwd_args(view_f, img_g, ag_g, thr_g, g_ones, p_full)
                cuda_impl._run(tiled.bwd_variant('softras_pxg_bwd', tiled.bwd_defines(b)),
                               'softras_pxg_bwd', args_v, dev)
                torch.cuda.synchronize()
                if not torch.equal(rv, grows_f):
                    raise AssertionError(f'pxg 1024 px: K9 build {b} differs from the default')
        # K8 on the overfull tile of the most items alone, and every other
        # build of THR_BUILDS twice at K = 16 and 40: the default build's map
        busy_o = int(over_f.long()[n_items[over_f.long()].argmax()])
        thr_busy_ms = timed(thr_alone(pin_f, depths_f, cnt_g, p_full, busy_o), reps=30)
        p40 = dataclasses.replace(p_full, max_faces_id=40)
        thr_40 = pxg_impl.launch_pxg_thr(pin_f, None, cnt_g, p40)
        thr_40_ms = timed(lambda: pxg_impl.launch_pxg_thr(pin_f, None, cnt_g, p40), reps=3)
        for b in pxg_impl.THR_BUILDS:
            for pp, dd, want_t in ((p_full, depths_f, thr_g), (p40, None, thr_40)):
                for _ in range(2):
                    args_v, thr_v = pxg_impl.thr_args(pin_f, dd, cnt_g, pp)
                    cuda_impl._run(pxg_impl.thr_variant(pxg_impl.thr_defines(b)),
                                   'softras_pxg_thr', args_v, dev)
                    torch.cuda.synchronize()
                    if not torch.equal(thr_v, want_t):
                        raise AssertionError(f'pxg 1024 px: K8 build {b} at K = '
                                             f'{pp.max_faces_id} differs from the default')
        thr_occ = pxg_impl.thr_occupancy(pxg_impl.thr_args(pin_f, depths_f, cnt_g, p_full)[0])
        fwd_occ = pxg_impl.fwd_occupancy(pxg_impl.fwd_args(pin_f, p_full, True)[0])
        bwd_occ = tiled.bwd_occupancy('softras_pxg_bwd', tiled.bwd_args(
            view_f, img_g, ag_g, thr_g, g_ones, p_full)[0])
        pxg_extra = {
            'fwd': {**fwd_occ, 'items': W_f, 'group': pxg_impl.GROUP,
                    'ms_no_lists': gm['fwd_nothr'], 'busiest_tile_ms': gm_busy['fwd'],
                    'busiest_tile_no_lists_ms': gm_busy['fwd_nothr'],
                    'busiest_tile_items': int(on_busy.sum().item()),
                    'busiest_tile_faces': hi_b - lo_b},
            'bwd': {**bwd_occ, 'items': W_f, 'group': pxg_impl.GROUP,
                    'busiest_tile_ms': gm_busy['bwd'],
                    'busiest_tile_items': int(on_busy.sum().item()),
                    'busiest_tile_faces': hi_b - lo_b, 'ms_items_of_8': bwd_8_ms},
            'thr': {**thr_occ, 'overfull_tiles': int(over_f.numel()),
                    'wrapper_ms': gm['thr_wrapper'], 'busiest_tile_ms': thr_busy_ms,
                    'busiest_tile_items': int(n_items[busy_o].item()), 'ms_k40': thr_40_ms,
                    'build': pxg_impl.THR_BUILD, 'builds': list(pxg_impl.THR_BUILDS)}}
        log(f'  softras_pxg_fwd: {fwd_occ["registers"]} registers, {fwd_occ["local_bytes"]} '
            f'bytes of local memory, {fwd_occ["blocks_per_sm"]} blocks an SM, {W_f} items; '
            f'the busiest tile\'s '
            f'{pxg_extra["fwd"]["busiest_tile_items"]} items ({hi_b - lo_b} faces) alone '
            f'{gm_busy["fwd"]:.4f} ms ({gm_busy["fwd_nothr"]:.4f} without the depth lists)  '
            f'[{smi}]')
        log(f'  softras_pxg_bwd: {bwd_occ["registers"]} registers, {bwd_occ["local_bytes"]} '
            f'bytes of local memory, {bwd_occ["blocks_per_sm"]} blocks an SM, {W_f} '
            f'items of at most {pxg_impl.GROUP} faces; the busiest tile\'s '
            f'{pxg_extra["bwd"]["busiest_tile_items"]} items alone {gm_busy["bwd"]:.4f} ms; '
            f'items of 8 faces {bwd_8_ms:.4f} ms, rows bit-equal  [{smi}]')
        log(f'  softras_pxg_thr: {thr_occ["registers"]} registers, {thr_occ["local_bytes"]} '
            f'bytes of local memory, {thr_occ["blocks_per_sm"]} blocks an SM, build '
            f'{pxg_impl.THR_BUILD}; the overfull tile of the most items '
            f'({pxg_extra["thr"]["busiest_tile_items"]}) alone {thr_busy_ms:.4f} ms; at K = 40 '
            f'{thr_40_ms:.4f} ms  [{smi}]')
        log(f'  K7 at caps {pxg_impl.FWD_CAPS} (twice with the depth lists, once without), '
            f'K9 builds {pxg_impl.BWD_BUILDS} (twice) and K8 builds {pxg_impl.THR_BUILDS} '
            f'(twice at K = 16 and 40): bit-equal to the default builds; the busiest '
            f'tile\'s items alone bit-equal to the frame\'s')

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
        want = dict.fromkeys(pxg_wrappers, TRAIN_STEPS)   # the threshold on every step too
        if train_pxg != want or any(read_counts().values()) or any(read_dir().values()) \
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

    def full_split_check(name, tag, pin, p, out):
        """The full frame's K3 or K5 outputs against the plain version of the
        split, and with hard rgb (the winners); the readings logged."""
        with_thr = out[3] is not None
        r = check_tile_split(name, tag, pin, p, with_thr, out)
        t_err[f'{name}_fwd'] = max(t_err[f'{name}_fwd'], r['max_err'])
        kw_h = dict(image_size=1024, aggr_func_rgb='hard')
        p_h = make_params(grad_mode='full', **kw_h) if name == 'fpx' else make_params(**kw_h)
        pin_h = fpx_impl.prep_fpx(fv_full, tex_full, p_h) if name == 'fpx' else \
            pxf_impl.prep_pxf(fv_full, tex_full, p_h)
        r_h = check_tile_split(name, f'{tag} hard rgb', pin_h, p_h, with_thr,
                               tile_fwd(name, pin_h, p_h, with_thr))
        log(f'  {tag} vs the plain version of its split: {r["split_plain"]}; hard rgb: '
            f'{r_h["split_plain"]}')

    def tile_fwd(name, pin, p, with_thr):
        """The route's counted forward wrapper (K3 or K5) on ``pin``."""
        if name == 'fpx':
            return fpx_impl.launch_fpx_fwd(pin, p)
        return pxf_impl.launch_pxf_fwd(pin, p, with_thr)

    def tile_variant_run(name, pin, p, with_thr, S):
        """A call of K3 or K5 built with S blocks per tile, and the outputs
        it writes (the default build: its wrapper, whose outputs are new
        at each call, None)."""
        if S == tiled.TILE_SPLIT:
            return (lambda: tile_fwd(name, pin, p, with_thr)), None
        source = f'softras_{name}_fwd'
        bounds = pxf_impl.thr_bisect_bounds(p.near, p.far) if with_thr else (0, 0, 0)
        args, out = tiled.fwd_args(pin, p, with_thr, bounds)
        fn = tiled.split_variant(source, S)
        return (lambda: cuda_impl._run(fn, source, args, dev)), list(out)

    def check_tile_split(name, tag, pin, p, with_thr, out, chunk_pairs=1 << 24):
        """K3 or K5 (``out``) twice, bit-equal; against the plain version of
        its split and merge (``tiled.fwd_split_plain``): images within
        TOL, aggregates within AGGR_RTOL relative (the shares beyond
        SPLIT_TOL are read), counts and hard winners equal, each on all but EDGE_FRAC
        of the pixels, thresholds at phase 3's tolerance; and built
        with the other blocks per tile of SPLITS: counts, winners and
        thresholds bit for bit, images within SPLIT_TOL on all but EDGE_FRAC.
        Returns the largest image difference (max_err) and the readings."""
        img, ag, cnt, thr = out
        again = tile_fwd(name, pin, p, with_thr)
        torch.cuda.synchronize()
        if not all(a is None and b is None or torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f'{tag}: two runs of the forward differ in their bits')
        want, ag_w, cnt_w, thr_w = tiled.fwd_split_plain(pin, p, with_thr,
                                                         chunk_pairs=chunk_pairs)
        f_img, e_img = beyond(img, want, SPLIT_TOL, pixel_dim=1)
        rel = (ag.double() - ag_w.double()).abs() / ag_w.double().abs().clamp_min(1.0)
        f_ag, e_ag = (rel > SPLIT_TOL).any(dim=1).float().mean().item(), rel.max().item()
        f_c = beyond(cnt.float(), cnt_w.float(), 0)[0]
        # the kernel's own arithmetic (expf, contractions, the online
        # softmax's rescaling where the plain version exponentiates once;
        # softras_pair.cuh) moves knife-edge pixels past SPLIT_TOL: images
        # held at TOL, the softmax sum S at AGGR_RTOL (at gamma = 1e-4 an
        # ulp of a depth moves a term of S by about 6e-4), the shares beyond
        # SPLIT_TOL read
        check(f'{tag} image vs split plain', beyond(img, want, TOL, pixel_dim=1)[0])
        check(f'{tag} aggregates vs split plain',
              (rel > AGGR_RTOL).any(dim=1).float().mean().item())
        check(f'{tag} count vs split plain', f_c)
        f_id = f_thr = 0.0
        if p.aggr_func_rgb == 'hard':
            f_id = beyond(ag[:, 1], ag_w[:, 1], 0)[0]
            check(f'{tag} face index vs split plain', f_id)
        if with_thr:
            f_thr = ((thr - thr_w).abs() > THR_RTOL * thr_w.abs()).float().mean().item()
            check(f'{tag} threshold vs split plain', f_thr, THR_FRAC)
        var = {}
        for S in SPLITS:
            if S == tiled.TILE_SPLIT:
                continue
            run, o = tile_variant_run(name, pin, p, with_thr, S)
            run()
            torch.cuda.synchronize()
            if not torch.equal(o[2], cnt) or (with_thr and not torch.equal(o[3], thr)) or (
                    p.aggr_func_rgb == 'hard' and not torch.equal(o[1][:, 1], ag[:, 1])):
                raise AssertionError(f'{tag}: counts, winners or thresholds at {S} blocks per '
                                     'tile differ')
            f_v, e_v = beyond(o[0], img, SPLIT_TOL, pixel_dim=1)
            check(f'{tag} image at {S} blocks per tile', f_v)
            var[S] = e_v
        return {'max_err': e_img, 'split_plain': (
            f'vs split plain: image {f_img:.6f} beyond {SPLIT_TOL} (max {e_img:.3g}), aggregates '
            f'{f_ag:.6f} (max rel {e_ag:.3g}), counts {f_c:.6f}, winners {f_id:.6f}, threshold '
            f'{f_thr:.6f}; counts, winners, thresholds bit-equal at {SPLITS} blocks per tile, '
            f'image max diff {var}; bit-equal twice')}

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
        e_split = check_tile_split(name, tag, pin, p, with_thr, (img, ag, cnt, thr))
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
               f'{f_rgb:.4f} beyond (max {e_rgb:.3g}), alpha {f_a:.4f}; {e_split["split_plain"]}')
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
        for k, e in (('fwd', max(e_rgb, e_a, e_thr, e_split['max_err'])), ('bwd', max(e_f, e_t))):
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
        dev_ms.update(device_ms(full_step, tiled_kernels('fpx'), reps=STEPS))
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
        full_split_check('fpx', 'f_px 1024 px', pin_x, p_full_f, (img_x, ag_x, cnt_x, None))
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
        frame's pair counts; the forward also on the busiest tile's faces
        alone and built with the other blocks per tile.  Returns (ms, plain
        ms, plain_on, library ms, bounds, the forward's extra keys)."""
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
        # the forward's split: the busiest tile's faces alone (before the
        # split that tile's blocks were the kernel's tail), and the frame and
        # that tile at each number of blocks per tile
        with_thr = name == 'pxf'
        busy = int(faces_t.argmax())
        ids_b = pin_k.entries[int(pin_k.tile_off[busy]):int(pin_k.tile_off[busy + 1])].long()
        sub = (fv_full[:, ids_b].contiguous(), tex_full[:, ids_b].contiguous(), p_k)
        pin_b = fpx_impl.prep_fpx(*sub) if name == 'fpx' else pxf_impl.prep_pxf(*sub)
        split_ms = {}
        for S in SPLITS:
            for which, pin_s in (('frame', pin_k), ('busiest tile', pin_b)):
                run, _ = tile_variant_run(name, pin_s, p_k, with_thr, S)
                split_ms[f'{S} {which}'] = timed(run, reps=30)
        row = pin_k.rows.shape[-1]
        own = tiled.fwd_own_bytes(p_k, with_thr)
        chunk = tiled.fwd_chunk(row, tiled.fwd_threads(pin_k.tile_h, pin_k.tile_w), own)
        smem = max(8 * chunk * (row + 1), 4 * tiled.FWD_STATE * tiled.FWD_PIX) + own
        log(f'  softras_{name}_fwd, blocks per tile (chosen {tiled.TILE_SPLIT}): ' + '; '.join(
            f'{S}: frame {split_ms[f"{S} frame"]:.4f} ms, busiest tile ({ids_b.numel()} faces) '
            f'alone {split_ms[f"{S} busiest tile"]:.4f} ms' for S in SPLITS)
            + f'; shared memory a block {smem:,} bytes ({chunk} faces a chunk, 2 buffers, '
            f'{own:,} bytes of the threshold\'s own), the same at every split  [{smi}]')
        extra = {'blocks_per_tile': tiled.TILE_SPLIT,
                 'busiest_tile_ms': split_ms[f'{tiled.TILE_SPLIT} busiest tile'],
                 'busiest_tile_faces': ids_b.numel(), 'ms_by_blocks_per_tile': split_ms,
                 'smem_bytes': smem}
        # the backward: its registers and blocks an SM (the CUDA runtime), its
        # work items, the busiest tile's faces alone, and vertex colours
        # (register sums, no texel adds) against surface T = 25 on the frame
        bwd_launch = fpx_impl.launch_fpx_bwd if name == 'fpx' else pxf_impl.launch_pxf_bwd
        occ = tiled.bwd_occupancy(f'softras_{name}_bwd',
                                  tiled.bwd_args(pin_k, img_k, ag_k, thr_k, g_ones, p_k)[0])
        img_b, ag_b, _, thr_b = tile_fwd(name, pin_b, p_k, with_thr)
        g_b = torch.ones_like(img_b)
        bwd_busy = timed(lambda: bwd_launch(pin_b, img_b, ag_b, thr_b, g_b, p_k), reps=30)
        p_v = dataclasses.replace(p_k, texture_type='vertex')
        gen.manual_seed(SEED + 15)
        tex_v = torch.rand((B, F, 3, 3), generator=gen, device=dev)
        pin_v = fpx_impl.prep_fpx(fv_full, tex_v, p_v) if name == 'fpx' else \
            pxf_impl.prep_pxf(fv_full, tex_v, p_v)
        img_v, ag_v, _, thr_v = tile_fwd(name, pin_v, p_v, with_thr)
        bwd_vertex = timed(lambda: bwd_launch(pin_v, img_v, ag_v, thr_v, g_ones, p_v), reps=30)
        bwd_extra = {**occ, 'items': W_k, 'group': impl.GROUP, 'busiest_tile_ms': bwd_busy,
                     'busiest_tile_faces': ids_b.numel(), 'vertex_colours_ms': bwd_vertex}
        log(f'  softras_{name}_bwd: {occ["registers"]} registers, {occ["local_bytes"]} bytes of '
            f'local memory, {occ["blocks_per_sm"]} blocks an SM; {W_k} work items of at most '
            f'{impl.GROUP} faces; the busiest tile ({ids_b.numel()} faces) alone {bwd_busy:.4f} '
            f'ms; vertex colours {bwd_vertex:.4f} ms against {ms["bwd"]:.4f} with surface T = '
            f'{pin_k.tex_res ** 2}  [{smi}]')
        return ms, plain, on, lib, bnd, extra, bwd_extra

    with route.with_layout('f_px'):
        fpx_t = tiled_timing(
            'fpx', pin_x, p_full_f, img_x, ag_x, None, census_f,
            lambda: torch_impl.forward_pixels(fv_full, tex_full, p_full_f, xk, yk,
                                              chunk_pairs=1 << 24),
            plain_bwd_fpx)

    # the grad_mode='full' step on both routes in turns: binned, f_px, f_px,
    # binned; CUDA events, then the host clock around steps that end in a
    # synchronize
    f_times = {'binned': [], 'f_px': []}
    for r_name in ('binned', 'f_px', 'f_px', 'binned'):
        with route.with_layout(r_name if r_name == 'f_px' else 'pxt'):
            t_r = timed(full_step, reps=STEPS)
            t0 = time.perf_counter()
            for i in range(STEPS):
                full_step(i)
            torch.cuda.synchronize()
            f_times[r_name].append((t_r, (time.perf_counter() - t0) * 1e3 / STEPS))
    log(f"  in turns (binned, f_px, f_px, binned), ms: grad_mode='full' soft_rasterize step, "
        f'events / host clock: {f_times}  [{smi}]')

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
        dev_ms.update(device_ms(bench_step, tiled_kernels('pxf'), reps=STEPS))
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
        full_split_check('pxf', 'px_f 1024 px', pin_p, p_full, (img_p, ag_p, cnt_p, thr_p))
        # the bands of 8 tile rows side by side equal the whole frame, bit for bit
        rows_p = pin_p.tiles_y // 4
        bands_p = [pxf_impl.launch_pxf_fwd(pxf_impl.prep_pxf(fv_full, tex_full, p_full,
                                                             ty0=k * rows_p, ty_band=rows_p),
                                           p_full, True) for k in range(4)]
        torch.cuda.synchronize()
        for i, full in enumerate((img_p, ag_p, cnt_p, thr_p)):
            if not torch.equal(torch.cat([o[i] for o in bands_p], dim=-2), full):
                raise AssertionError(f'px_f 1024 px: output {i} of 4 bands differs from the '
                                     'whole frame\'s')
        log(f'  px_f 1024 px in 4 bands of {rows_p} tile rows: image, aggregates, counts and '
            'thresholds equal to the whole frame\'s, bit for bit')
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

    # ---- 15. the files and the scene at full width ----------------------------
    p15 = files_and_scene(dict(dev=dev, smi=smi, zero_counts=zero_counts,
                               read_counts=read_counts, sample_pixels=sample_pixels,
                               pixels_vs_plain=pixels_vs_plain, no_dir=no_dir, no_pxg=no_pxg))
    log(json.dumps({'phase15': p15}))

    # ---- 16. volume rendering and NeRF -----------------------------------------------
    def read_all():
        ws = (*wrappers.values(), *dir_wrappers.values(), *pxg_wrappers.values(),
              *tiled_wrappers.values(), segment_sum.launch_segment_sum, *n_wrappers.values())
        return sum(w.launches for w in ws)

    def zero_all():
        zero_counts()
        for w in n_wrappers.values():
            w.launches = 0

    p16 = nerf_stack(dict(dev=dev, smi=smi, zero_counts=zero_all, read_all=read_all))
    log(json.dumps({'phase16': p16}))

    # ---- 17. the parallel stack -------------------------------------------------------
    p17 = parallel_stack(dict(dev=dev, smi=smi, fv=fv_full, tex=tex_full, p=p_full,
                              zero_counts=zero_all, read_counts=read_counts,
                              read_tiled=read_tiled, nerf_ms=p16['16b']['ms_per_step']))
    log(json.dumps({'phase17': p17}))

    def band_ms(name):
        """The kernel's device ms on each band of 4 (phase 17c), both layouts."""
        return {m: [b[name] for b in p17['balance_n4'][m]['bands']] for m in ('stride', 'contig')}

    # ---- 18. the Hopper probes of the TPU tools ---------------------------------------
    probe_main = {k: w.launches for k, w in probe_wrappers.items()}
    if any(probe_main.values()):
        raise AssertionError(f'a probe ran during phases 3-17: {probe_main}')
    p18 = probe_phase(dict(repo=repo, smi=smi, reps=10))
    log(json.dumps({'phase18': p18}))

    # ---- 19. results ----------------------------------------------------
    launches = {**step_counts, **n_step_counts, **dir_counts, **pxg_counts, **fpx_counts,
                **pxf_counts}
    # the face sum ran in the pxg, f_px and px_f steps alike
    launches['segment_sum'] = sum(c['segment_sum'] for c in (pxg_counts, fpx_counts,
                                                              pxf_counts))

    def entry(name, source, replaces, err, ms, plain_ms, plain_on, b, library_ms=None):
        # ms: the wrapper, CUDA events around its calls; device_ms: the kernel's
        # own device time per launch in its route's step (torch.profiler)
        return {'name': name, 'route': 'cuda',
                'source': f'jrender_tpu_torch/csrc/{source}', 'replaces': replaces,
                'launches': launches[name], 'max_abs_err': err, 'ms': ms,
                'device_ms': dev_ms[name],
                'plain_ms': plain_ms, 'plain_on': plain_on, 'bound_ms': b[0],
                'bound_by': b[1], 'library_ms': library_ms}

    kernels_line = [
        {**entry('softras_fwd', 'softras_fwd.cu', 'jrender_tpu/ops/softras/pxt_impl.py:370',
                 fwd_err, fwd_ms, fwd_plain_ms, some, fwd_bound),
         'blocks_per_tile': cuda_impl.FWD_SPLIT, 'busiest_tile_ms': fwd_busy_ms,
         'launches_files_scene': p15['k1_launches'], 'max_abs_err_files_scene': p15['err'],
         'launches_sharded': p17['launches_pxt']['softras_fwd'],
         'band_device_ms_n4': band_ms('softras_fwd')},
        {**entry('softras_thr', 'softras_thr.cu', 'jrender_tpu/ops/softras/pxt_impl.py:584',
                 thr_err, thr_ms, thr_plain_ms, some, thr_bound),
         'blocks_per_tile': cuda_impl.FWD_SPLIT, 'busiest_tile_ms': thr_busy_ms,
         'ms_k40': thr_k40_ms, 'launches_sharded': p17['launches_pxt']['softras_thr'],
         'band_device_ms_n4': band_ms('softras_thr')},
        {**entry('softras_bwd', 'softras_bwd.cu', 'jrender_tpu/ops/softras/pxt_impl.py:856',
                 bwd_err, bwd_ms, bwd_plain_ms, some, bwd_bound),
         'blocks_per_tile': cuda_impl.BWD_SPLIT, 'busiest_tile_ms': bwd_busy_ms,
         'launches_sharded': p17['launches_pxt']['softras_bwd'],
         'band_device_ms_n4': band_ms('softras_bwd')},
        {**entry('softras_bwd_reduce', 'softras_bwd.cu',
                 'jrender_tpu/ops/softras/pxt_impl.py:1128', red_err, red_ms, red_plain_ms,
                 'all rows', red_bound, red_lib_ms),
         'launches_sharded': p17['launches_pxt']['softras_bwd_reduce'],
         'band_sum_err': max(max(v) for v in p17['grad_sum_err'].values())},
        {**entry('n3mr_maps', 'n3mr_maps.cu', 'jrender_tpu/ops/n3mr/pallas_impl.py:34',
                 n_err['n3mr_maps'], maps_ms, maps_plain_ms, f'{SAMPLES} of {HW_n} pixels',
                 maps_bound),
         'registers': maps_occ['registers'], 'local_bytes': maps_occ['local_bytes'],
         'blocks_per_sm': maps_occ['blocks_per_sm'], 'tiles_per_cluster': ncuda.MAPS_SPLIT,
         'busiest_cluster_ms': maps_busy_ms, 'busiest_tile_faces': int(lists_n.counts[0, busy_n]),
         'busiest_cluster_faces': busy_cluster_faces,
         'build': ncuda.MAPS_BUILD, 'builds': list(ncuda.MAPS_BUILDS)},
        entry('n3mr_texbwd', 'n3mr_texbwd.cu', 'jrender_tpu/ops/n3mr/pallas_impl.py:347',
              n_err['n3mr_texbwd'], texbwd_ms, texbwd_plain_ms, 'the whole frame',
              texbwd_bound, texbwd_lib_ms),
        entry('n3mr_edge_bands', 'n3mr_edgebwd.cu', 'jrender_tpu/ops/n3mr/banded_bwd.py:56',
              n_err['n3mr_edge_bands'], bands_ms, bands_plain_ms, 'all items', bands_bound),
        {**entry('n3mr_edgebwd', 'n3mr_edgebwd.cu', 'jrender_tpu/ops/n3mr/banded_bwd.py:347',
                 n_err['n3mr_edgebwd'], edgebwd_ms, edge_plain_ms,
                 f'{ids_n.numel()} of {F_n} faces', edgebwd_bound),
         'band_rows': ncuda.EDGE_BAND, 'band_bytes_ms': band_bytes_ms,
         'ms_2048': edgebwd_aa_ms, 'bound_ms_2048': edgebwd_aa_bound[0]},
        {**entry('softras_dir_prep', 'softras_dir_prep.cu',
                 'jrender_tpu/ops/softras/dir_impl.py:99', 0.0, small['prep_kernel_ms'],
                 small['prep_plain_ms'], 'the whole table', small['prep_bound']),
         'faces': small['faces'], 'ms_3330': middle['prep_kernel_ms'],
         'ms_39474': large['prep_kernel_ms'], 'ms_demo2': demo_d['prep_kernel_ms']},
        {**entry('softras_dir_fwd', 'softras_dir_fwd.cu',
                 'jrender_tpu/ops/softras/dir_impl.py:202', max(d_err['fwd'], small['fwd_err']),
                 small['fwd_ms'], small['fwd_plain_ms'], small['plain_on'], small['fwd_bound']),
         'faces': small['faces'], 'ms_nothr': small['fwd_nothr_ms'],
         'ms_3330': middle['fwd_ms'], 'bound_ms_3330': middle['fwd_bound'][0],
         'ms_39474': large['fwd_ms'], 'ms_demo2': demo_d['fwd_ms']},
        {**entry('softras_dir_bwd', 'softras_dir_bwd.cu',
                 'jrender_tpu/ops/softras/dir_impl.py:480', max(d_err['bwd'], small['bwd_err']),
                 small['bwd_ms'], small['bwd_plain_ms'], small['plain_on'], small['bwd_bound']),
         'faces': small['faces'], 'ms_3330': middle['bwd_ms'],
         'bound_ms_3330': middle['bwd_bound'][0], 'ms_39474': large['bwd_ms'],
         'ms_demo2': demo_d['bwd_ms'],
         'items': {k: r['bwd_items'] for k, r in (('288', small), ('3330', middle),
                                                  ('39474', large), ('demo2', demo_d))},
         'part_bytes': {k: r['bwd_part_bytes'] for k, r in (
             ('288', small), ('3330', middle), ('39474', large), ('demo2', demo_d))},
         'peak_bytes': {k: r['bwd_peak_bytes'] for k, r in (
             ('288', small), ('3330', middle), ('39474', large), ('demo2', demo_d))},
         'first_design_part_bytes_39474': large['bwd_first_design_part_bytes'],
         'wait_ms': small['soft_rasterize_wait_ms']},
        *({**entry(f'softras_pxg_{k}', src, rep, g_err[k], gm[k], gm_plain[k], gm_on[k], gb[k],
                   gm_lib.get(k)), **pxg_extra.get(k, {})}
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
        *({**entry(f'softras_{r}_{k}', f'softras_{r}_{k}.cu',
                   f'jrender_tpu/ops/softras/pallas_impl.py:{line}',
                   t_err[f'{r}_{k}'], tm[0][k], tm[1][k], tm[2][k], tm[4][k], tm[3].get(k)),
           **(tm[5] if k == 'fwd' else tm[6])}
          for r, tm, rows_ in (('fpx', fpx_t, ((313, 'fwd'), (442, 'bwd'))),
                               ('pxf', pxf_t, ((894, 'fwd'), (1161, 'bwd'))))
          for line, k in rows_),
        *probe_entries(p18, probe_main),
    ]
    # K6 timed alone by T3's stage tool (phase 18c), on both spheres
    for e in kernels_line:
        if e['name'] == 'softras_pxf_bwd':
            e['stage_tool_device_ms'] = {n: r['k6']['kernel_device_ms']
                                         for n, r in p18['T3'].items()}
            e['stage_tool_items'] = {n: r['items'] for n, r in p18['T3'].items()}
    log(json.dumps({'kernels': kernels_line}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
