#!/usr/bin/env python3
"""Hold two trees of the port's SoftRas kernels (and N3MR's edge gradient)
against each other on one CUDA card: their outputs bit for bit and their
times in turns.

    python3 tools/compare_softras_trees.py --parent PATH [--change PATH]
                                           [--parts binned,tiled,pxg,n3mr,dir]

PATH is another checkout of the port (for example ``git archive`` of the
parent commit unpacked into a git-ignored directory); ``--change`` is this
tree unless given (give the parent twice to read one tree in four turns);
``--parts`` keeps some of the parts below (all by default).  On the 39,474-face
``uv_sphere(130, 153)`` at 1024 px, demo 1's camera at 45 degrees, 5x5
texels per face, the renderer's defaults (K = 16), this tree first makes
the inputs: the rasterizer's face vertices and textures, its forward
outputs, threshold map and a seeded incoming gradient.  Then each tree, in
a process of its own that imports only that tree's ``jrender_tpu_torch``,
in the turns parent, change, change, parent:

  * runs the forward kernel (``cuda_impl.launch``) on the inputs' faces,
    and the threshold kernel (``launch_thr``) on them with the common
    candidate counts, at K = 16 and at K = 40 (past the K-smallest lists:
    the threshold's bisection);
  * runs the backward kernels and the face reduction (``launch_bwd``,
    ``launch_reduce``) on the common forward outputs, threshold and
    gradient, so that both trees' backwards read the same bits;
  * times the forward, threshold (K = 16 and 40), backward and reduction
    kernels alone and
    the forward, threshold and backward on the busiest tile's faces alone
    (CUDA events, the median of 5 rounds of 20 launches after a warm-up);
  * reads the reduction's device time alone: its arguments made once by
    the tree's ``reduce_args`` (a tree without it: its wrapper, whose host
    work the device time does not read), the kernel's own time per launch
    from torch.profiler (this checkout's ``device_time.py``, the median
    over 20 launches); and runs it, and reads it so, on the slot rows of three
    more inputs: the 288- and 3,330-face spheres at 1024 px and demo 2's
    first step (T = 1), each tree's forward and backward making the rows;
  * runs the f_px backward (K4, ``grad_mode='full'``) and the px_f
    backward (K6, K = 16), softmax and hard rgb, each on common forward
    outputs (this tree's K3 and K5) and a seeded incoming gradient, then the
    face sum after it, and times both on the softmax frame;
  * runs the pxg route's kernels (``pxg``), softmax and hard rgb at K = 16:
    the partials with the depth lists (K7, ``launch_pxg_fwd``), the combine,
    the threshold (K8) on them (and at K = 40, its bisection), and the
    backward (K9, ``launch_pxg_bwd``) with the face sum on common forward
    outputs, threshold and a seeded incoming gradient; times K7 with and
    without the depth lists, the combine, K8's wrapper (``launch_pxg_thr``)
    and K8 alone (its arguments made before the timing, ``thr_kernel``), K8
    at K = 40, K9 and the face sum on the softmax frame, K7 and K9 on the
    busiest tile's work items alone (the items of that tile on the frame's
    inputs) and K8 alone on the overfull tile of the most items; the
    combine's (``combine_args``) and the face sum's device time alone;
  * runs N3MR's z-buffer (K12, ``n3mr.cuda_impl.launch_maps``) and edge
    gradient (``launch_edgebwd``, what the tree launches for it) on the
    sphere at 1024 px (phase 9 of ``chip_smoke.py``: 2x2x2 texels; the edge
    gradient on common maps, a seeded incoming rgb gradient, its inputs
    from ``edge_inputs``); times both, and the z-buffer on the busiest
    tile's list alone (the whole grid, every other list empty), on empty
    lists and, where the tree's ``maps_args`` takes ``tile``, on the
    busiest tile's cluster alone (``n3mr_maps``); the band keys' device
    time alone; and the texture gradient (K13, ``launch_texbwd``) on common
    maps and a seeded rgb gradient of four inputs: the 39,474-, 288- and
    3,330-face spheres at 1024 px at texture sizes 2 and 4, and demo 4's
    first fit step (256 px, 2,600 faces, size 4, caught on its way to the
    wrapper), each held bit for bit between the trees and timed by its
    wrapper and by its device time alone (``texbwd_args``);
  * runs the dir route's kernels (``dir``) on four inputs: the 288-,
    3,330- and 39,474-face spheres (``uv_sphere(13, 12)``, ``(38, 45)``,
    ``(130, 153)``) at 1024 px with the renderer's defaults, and demo 2's
    first step (120 views at 64 px, 1,300 faces; ``chip_smoke.py`` phase 7):
    the forward (K10) with the threshold at K = 16 and at K = 40 (its
    bisection) and without it, and the backward (K11) at K = 16 and at
    ``grad_mode='full'`` on common forward outputs and a seeded incoming
    gradient; times each (K = 40 over fewer launches), reads K11's launched
    warps, its live (face, split) items, the bytes of its partial rows and
    ``torch.cuda.max_memory_allocated`` above the start around one call,
    and the wait of a step's backward on the item count where the tree has
    one; on the 288-face sphere, the device time and kernel launches of a
    dir ``soft_rasterize`` step (torch.profiler);
  * times the steps that run them: ``soft_rasterize(...).sum().backward()``
    (CUDA events), and ``Renderer.render_mesh`` frames and forward +
    backward steps (host clock around work that ends in a synchronize;
    the median of 5 rounds of 10), and the device time of each step
    (torch.profiler over 4 steps: the kernels' summed device time); the
    f_px, px_f and pxg steps alike under their ``JR_LAYOUT``, the pxg
    step also with each kernel's device time by name.

It prints one JSON line: the card's name and power limit, each turn's
times, and whether the trees agree: the forward's candidate counts and
softmax maximum M bit for bit, the largest image difference and relative
difference of the softmax sum S, the threshold maps (K = 16 and 40) bit
for bit, the
backward's slot rows (the rows the
tile runs fill, and the big faces' rows) and reduced gradients bit for
bit, the f_px and px_f counts, hard winners (ids and depths) and px_f
threshold maps (K = 16 and 40) bit for bit and their largest image
difference, K4's and K6's entry rows and face sums bit for bit, K7's
partial rows and depth lists, the combine's image, aggregates and counts,
K8's threshold maps (K = 16 and 40), K9's entry rows and face sums bit
for bit (softmax and hard rgb), K12's six maps bit for bit, K13's
gradients and the reduction's on every input bit for bit, K10's image,
aggregates, counts and thresholds (K = 16, 40 and none) and K11's face and
texture gradients (K = 16 and ``grad_mode='full'``) bit for bit on each
dir input, each tree's
two turns bit for bit, the census of N3MR's tile lists (entries and front
faces), and the largest difference of the
two trees' edge gradients as a share of its largest entry (they sum in
another order where the kernel was redesigned).

Needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _device_ms():
    """``device_ms`` of this checkout's ``jrender_tpu_torch/utils/
    device_time.py``, loaded from its file alone: both trees are timed by the
    same timer, and the process imports no second ``jrender_tpu_torch``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        '_device_time', REPO / 'jrender_tpu_torch' / 'utils' / 'device_time.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def scene(torch, dev):
    """The sphere and renderer of the comparison: demo 1's camera at 45
    degrees, seeded textures."""
    from jrender_tpu_torch import Mesh, Renderer
    from jrender_tpu_torch.utils.primitives import uv_sphere
    v, f = uv_sphere(130, 153)
    gen = torch.Generator(device=dev).manual_seed(0)
    tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
    renderer = Renderer(image_size=1024)
    renderer.transform.set_eyes_from_angles(2.732, 30, 45)
    return v, f, tex, renderer, gen


def step_times(torch, np, fv, tex, timed, parts):
    """The steps' times in ms: soft_rasterize's (CUDA events), render_mesh's
    frame and step (host clock), and the device time of each step; the
    f_px and px_f steps with ``tiled`` in ``parts``, the pxg step (and its
    kernels' device time by name) with ``pxg``, the binned ones with
    ``binned``."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.ops.softras import soft_rasterize
    dev = fv.device
    v, f, tex_m, renderer, _ = scene(torch, dev)
    fv_leaf = fv.detach().clone().requires_grad_(True)
    tex_leaf = tex.detach().clone().requires_grad_(True)
    mesh = Mesh(v, f, textures=tex_m, texture_res=5)
    v_leaf = torch.tensor(v, device=dev).requires_grad_(True)
    t_leaf = tex_m.clone().requires_grad_(True)
    mesh_g = Mesh(v_leaf, f, textures=t_leaf, texture_res=5)

    def raster_step():
        fv_leaf.grad = tex_leaf.grad = None
        soft_rasterize(fv_leaf, tex_leaf, image_size=1024).sum().backward()

    def frame():
        mesh.reset_()
        with torch.no_grad():
            renderer.render_mesh(mesh, mode='rgb')

    def render_step():
        v_leaf.grad = t_leaf.grad = None
        mesh_g.reset_()
        alpha, rgb = renderer.render_mesh(mesh_g, mode=None)
        (alpha.sum() + rgb.sum()).backward()

    def wall(fn, reps=10, rounds=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / reps)
        return float(np.median(times))

    def full_step():
        fv_leaf.grad = tex_leaf.grad = None
        soft_rasterize(fv_leaf, tex_leaf, image_size=1024, grad_mode='full').sum().backward()

    def device(fn, reps=4, by_name=False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in ev) / 1e3 / reps
        if not by_name:
            return total
        return total, {e.key: e.self_device_time_total / 1e3 / reps for e in ev
                       if 'softras' in e.key or 'segment' in e.key}

    from jrender_tpu_torch.ops.softras import route
    out = {}
    steps = []
    if 'tiled' in parts:
        steps += [('f_px', 'fpx_full', full_step), ('px_f', 'pxf', raster_step)]
    if 'pxg' in parts:
        steps.append(('pxg', 'pxg', raster_step))
    for layout, tag, fn in steps:
        with route.with_layout(layout):
            out.update({f'{tag}_step_ms': timed(fn, reps=10), f'{tag}_step_wall_ms': wall(fn)})
            if layout == 'pxg':
                out['pxg_step_device_ms'], out['pxg_step_kernels_device_ms'] = device(
                    fn, by_name=True)
            else:
                out[f'{tag}_step_device_ms'] = device(fn)
    if 'binned' in parts:
        out.update({'soft_rasterize_step_ms': timed(raster_step, reps=10),
                    'render_mesh_frame_ms': wall(frame), 'render_mesh_step_ms': wall(render_step),
                    'soft_rasterize_step_device_ms': device(raster_step),
                    'render_mesh_frame_device_ms': device(frame),
                    'render_mesh_step_device_ms': device(render_step)})
    return out


N3MR_EPS = 1e-4   # rasterize's default


def n3mr_inputs(torch, dev, v, f, gen):
    """The z-buffer's and the edge gradient's inputs of chip_smoke.py's
    phase 9: the sphere in front of the camera at 1024 px, 2x2x2 texels a
    face; the edge gradient's from the z-buffer's maps and a seeded incoming
    rgb gradient, alpha taking none.  Returns (faces, textures, edge
    inputs)."""
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.transform import look_at, perspective
    vt = perspective(look_at(torch.tensor(v, device=dev)[None], (0.0, 0.0, -2.732)), angle=30)
    fv = face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9)
    tex = torch.rand((1, fv.shape[1], 2, 2, 2, 3), generator=gen, device=dev)
    _, fi, _, _, _, _, rgb = ncuda.forward_maps(fv, tex, 1024, 0.1, 100.0, N3MR_EPS)
    g_rgb = torch.randn(rgb.shape, generator=gen, device=dev)
    alpha = (fi >= 0).float()
    return fv, tex, ncuda.edge_inputs(fv, fi, rgb, alpha, g_rgb, alpha, 1024, True, False)


def sphere_maps(torch, dev, v, f, gen, is_=1024):
    """The texture gradient's inputs on a sphere in phase 9's camera at
    ``is_`` px: the forward's rows and maps (``forward_maps``) and a seeded
    incoming rgb gradient, with the eps they were made with."""
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.transform import look_at, perspective
    vt = perspective(look_at(torch.tensor(v, device=dev)[None], (0.0, 0.0, -2.732)), angle=30)
    fv = face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9)
    rows, fi, wt, dp, _, zc, _ = ncuda.forward_maps(fv, None, is_, 0.1, 100.0, N3MR_EPS)
    g_rgb = torch.randn(wt.shape, generator=gen, device=dev)
    return rows, fi, wt, dp, zc, g_rgb, N3MR_EPS


def demo4_maps(torch, dev):
    """The texture gradient's inputs of demo 4's first fit step
    (``chip_smoke.py`` phase 10: 256 px, the 1,300-face sphere, texture size
    4, an orthographic camera): the arguments of its one
    ``launch_texbwd`` call, caught on their way to the wrapper."""
    import numpy as np
    from jrender_tpu_torch import Renderer
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.utils.primitives import uv_sphere
    v, f = uv_sphere(26, 26)
    verts = torch.tensor(v * np.float32(0.5 / 0.85), device=dev)[None] * 0.6 / 0.5
    faces = torch.tensor(f, device=dev)[None]
    fitter = Renderer(camera_mode='look_at', perspective=False, light_intensity_directionals=0.0,
                      light_intensity_ambient=1.0, dr_type='n3mr')
    fitter.transform.set_eyes_from_angles(2.732, 0, float(np.random.RandomState(1).uniform(0, 360)))
    gen = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        goal = fitter(verts, faces, torch.rand((1, f.shape[0], 4, 4, 4, 3), generator=gen,
                                               device=dev))
    tex_fit = torch.ones((1, f.shape[0], 4, 4, 4, 3), device=dev, requires_grad=True)
    caught, wrapper = [], ncuda.launch_texbwd

    def catch(rows, tex_shape, fi, wt, dp, zc, g, eps):
        caught.append((rows, fi, wt, dp, zc, g.contiguous(), eps))
        return wrapper(rows, tex_shape, fi, wt, dp, zc, g, eps)

    catch.launches = 0      # the wrapper counts its launches under its module name
    ncuda.launch_texbwd = catch
    try:
        ((fitter(verts, faces, torch.tanh(tex_fit)) - goal) ** 2).sum().backward()
    finally:
        ncuda.launch_texbwd = wrapper
    if len(caught) != 1:
        raise AssertionError(f'demo 4 step: {len(caught)} texture-gradient launches')
    return caught[0]


# K13's inputs and the texture sizes each is read at
TEX_INPUTS = {'tex_39474': ((130, 153), (2, 4)), 'tex_288': ((13, 12), (2, 4)),
              'tex_3330': ((38, 45), (2, 4)), 'tex_demo4': (None, (4,))}


def tex_inputs(torch, dev, gen):
    """K13's common inputs by the keys of TEX_INPUTS: (rows, face_index,
    weight, depth, zcorn, grad_rgb, eps)."""
    from jrender_tpu_torch.utils.primitives import uv_sphere
    return {key: sphere_maps(torch, dev, *uv_sphere(*rs), gen) if rs else demo4_maps(torch, dev)
            for key, (rs, _) in TEX_INPUTS.items()}


def alone(mod, args_fn, source, entry, args_type, dev, wrapper, *a):
    """A callable that launches a kernel alone: its arguments made now by
    ``mod.<args_fn>`` where the tree has that function, else (a tree before
    the ``*_args`` functions) the wrapper ``wrapper(*a)``, whose host work
    the device time does not read."""
    if not hasattr(mod, args_fn):
        return lambda: wrapper(*a)
    from jrender_tpu_torch.ops.softras import cuda_impl
    args, keep = getattr(mod, args_fn)(*a)
    fn = cuda_impl._entry(source, entry, getattr(mod, args_type))

    def run():
        cuda_impl._run(fn, entry, args, dev)
    run.keep = keep      # the tensors that args point into
    return run


def texbwd(torch, tex_in, times, timed, digest):
    """K13 of this tree on its common inputs at the texture sizes of
    TEX_INPUTS: the gradients as digests by '<key>_ts<ts>'; adds to
    ``times`` the wrapper's time and the kernel's device time alone."""
    device_ms = _device_ms()
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    out = {}
    for key, (rows, fi, wt, dp, zc, g, eps) in tex_in.items():
        for ts in TEX_INPUTS[key][1]:
            a = (rows, (*rows.shape[:2], ts, ts, ts, 3), fi, wt, dp, zc, g, eps)
            out[f'{key}_ts{ts}'] = digest(ncuda.launch_texbwd(*a))
            times[f'{key}_texbwd_ts{ts}_ms'] = timed(lambda: ncuda.launch_texbwd(*a))
            times[f'{key}_texbwd_ts{ts}_device_ms'] = device_ms(
                alone(ncuda, 'texbwd_args', 'n3mr_texbwd', 'n3mr_texbwd', '_TexBwdArgs',
                      rows.device, ncuda.launch_texbwd, *a), {'k': ('n3mr_texbwd_kernel',)})['k']
        times[f'{key}_faces'] = rows.shape[1]
    torch.cuda.synchronize()
    return out


MAPS = ('face_index', 'weight', 'depth', 'face_inv', 'zcorn', 'rgb')


def n3mr_maps(torch, fv, tex, times, timed, digest):
    """The z-buffer (K12, ``n3mr.cuda_impl.launch_maps``) of this tree on
    the sphere at 1024 px: its six maps as digests; adds to ``times`` its
    time on the frame, on the busiest tile's list alone (every other tile's
    list empty, the whole grid launched), on empty lists (the epilogue and
    the writes alone) and, where ``maps_args`` takes ``tile``, on the
    busiest tile's cluster alone (a grid of that one cluster, on the
    frame's lists; its arguments made before the timing).
    Returns (digests, census): the census counts the tile lists' entries
    and their front faces, of all tiles and of the busiest."""
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    rows = nplain.face_rows(fv, 1024)
    lists = ncuda.tile_lists(fv, 1024)
    maps = ncuda.launch_maps(rows, lists, tex, 1024, 0.1, 100.0, N3MR_EPS)
    torch.cuda.synchronize()
    busy = int(lists.counts[0].argmax())
    rc = lists.run_counts
    one = lists._replace(run_counts=torch.where(
        torch.arange(rc.shape[1], device=rc.device) == busy, rc, 0).contiguous())
    empty = lists._replace(run_counts=torch.zeros_like(rc), gcount=torch.zeros_like(lists.gcount))
    for tag, cl in (('', lists), ('_busiest_tile', one), ('_empty_lists', empty)):
        times[f'n3mr_maps{tag}_ms'] = timed(
            lambda cl=cl: ncuda.launch_maps(rows, cl, tex, 1024, 0.1, 100.0, N3MR_EPS))
    if hasattr(ncuda, 'maps_args') and 'tile' in inspect.signature(ncuda.maps_args).parameters:
        from jrender_tpu_torch.ops.softras import cuda_impl
        args, _ = ncuda.maps_args(rows, lists, tex, 1024, 0.1, 100.0, N3MR_EPS, tile=busy)
        fn = ncuda.maps_variant()
        times['n3mr_maps_busiest_cluster_ms'] = timed(
            lambda: cuda_impl._run(fn, 'n3mr_maps', args, rows.device))
    front = rows[0, :, nplain.ROW_FRONT] > 0.5
    ids = lists.faces_sorted[0, :int(rc.sum())].long()
    s = int(lists.starts[0, busy])
    ids_b = lists.faces_sorted[0, s:s + int(rc[0, busy])].long()
    census = {'faces': int(fv.shape[1]), 'front_faces': int(front.sum()),
              'big_faces': int(lists.gcount.sum()), 'list_entries': ids.numel(),
              'list_front_entries': int(front[ids].sum()), 'busiest_tile': busy,
              'busiest_tile_entries': ids_b.numel(),
              'busiest_tile_front_entries': int(front[ids_b].sum())}
    return {k: digest(m) for k, m in zip(MAPS, maps)}, census


def tiled_forwards(torch, fv, tex, times, timed):
    """The f_px (K3) and px_f (K5) forwards on the faces at 1024 px, each
    route's binning at its own tiles: softmax and hard rgb, K5 with its
    threshold at K = 16 and at K = 40.  Adds to ``times`` each kernel's time
    on the softmax frame and on the busiest tile's faces alone.  Returns
    the outputs by '<route>_<rgb>' (and 'pxf_k40')."""
    from jrender_tpu_torch.ops.softras import fpx_impl, make_params, pxf_impl
    out = {}
    for name in ('fpx', 'pxf'):
        for rgb in ('softmax', 'hard'):
            kw = dict(image_size=1024, aggr_func_rgb=rgb)
            if name == 'fpx':
                p = make_params(grad_mode='full', **kw)
                prep = lambda f, t, p=p: fpx_impl.prep_fpx(f, t, p)
                fwd = lambda pin, p=p: fpx_impl.launch_fpx_fwd(pin, p)
            else:
                p = make_params(**kw)
                prep = lambda f, t, p=p: pxf_impl.prep_pxf(f, t, p)
                fwd = lambda pin, p=p: pxf_impl.launch_pxf_fwd(pin, p, True)
            pin = prep(fv, tex)
            out[f'{name}_{rgb}'] = fwd(pin)
            if rgb != 'softmax':
                continue
            times[f'{name}_fwd_ms'] = timed(lambda: fwd(pin))
            sizes = pin.tile_off[1:] - pin.tile_off[:-1]
            busy = int(sizes.argmax())
            ids = pin.entries[int(pin.tile_off[busy]):int(pin.tile_off[busy + 1])].long()
            sub = prep(fv[:, ids].contiguous(), tex[:, ids].contiguous())
            times[f'{name}_fwd_busiest_tile_alone_ms'] = timed(lambda: fwd(sub))
            times[f'{name}_busiest_tile_faces'] = ids.numel()
            if name == 'pxf':
                p40 = make_params(image_size=1024, max_faces_per_pixel_for_grad=40)
                out['pxf_k40'] = pxf_impl.launch_pxf_fwd(pin, p40, True)
                times['pxf_fwd_k40_ms'] = timed(lambda: pxf_impl.launch_pxf_fwd(pin, p40, True),
                                                reps=5)
    torch.cuda.synchronize()
    return out


TILED_BWD = {'fpx_softmax': dict(grad_mode='full'), 'fpx_hard': dict(grad_mode='full',
                                                                   aggr_func_rgb='hard'),
             'pxf_softmax': {}, 'pxf_hard': dict(aggr_func_rgb='hard')}


def tiled_bwd_inputs(torch, fv, tex, gen):
    """The common inputs of the f_px (K4, ``grad_mode='full'``) and px_f (K6,
    K = 16) backwards at 1024 px, softmax and hard rgb: each route's forward
    outputs (images, aggregates, threshold or None) and a seeded incoming
    gradient, by the keys of TILED_BWD."""
    from jrender_tpu_torch.ops.softras import fpx_impl, make_params, pxf_impl
    out = {}
    for key, kw in TILED_BWD.items():
        p = make_params(image_size=1024, **kw)
        if key.startswith('fpx'):
            img, ag, _, thr = fpx_impl.launch_fpx_fwd(fpx_impl.prep_fpx(fv, tex, p), p)
        else:
            img, ag, _, thr = pxf_impl.launch_pxf_fwd(pxf_impl.prep_pxf(fv, tex, p), p, True)
        out[key] = (img, ag, thr, torch.randn(img.shape, generator=gen, device=fv.device))
    return out


def tiled_backwards(torch, fv, tex, common, times, timed, digest):
    """K4 and K6 on the common inputs, and the face sum after them: the
    entry rows' and the face sums' digests by key; adds to ``times`` each
    kernel's time on the softmax frame."""
    from jrender_tpu_torch.ops.softras import fpx_impl, make_params, pxf_impl, tiled
    out = {}
    for key, kw in TILED_BWD.items():
        p = make_params(image_size=1024, **kw)
        img, ag, thr, g = common[key]
        if key.startswith('fpx'):
            pin = fpx_impl.prep_fpx(fv, tex, p, for_grad=True)
            run = lambda pin=pin, p=p: fpx_impl.launch_fpx_bwd(pin, img, ag, thr, g, p)
        else:
            pin = pxf_impl.prep_pxf(fv, tex, p, for_grad=True)
            run = lambda pin=pin, p=p: pxf_impl.launch_pxf_bwd(pin, img, ag, thr, g, p)
        rows = run()
        gf, gt = tiled.face_sum(pin, rows, p)
        torch.cuda.synchronize()
        out[key] = {'rows': digest(rows), 'sums': digest(gf, gt), 'items': pin.items.shape[0]}
        if key.endswith('softmax'):
            times[f'{key[:3]}_bwd_ms'] = timed(run)
            times[f'{key[:3]}_bwd_items'] = pin.items.shape[0]
    return out


PXG = {'pxg_softmax': {}, 'pxg_hard': dict(aggr_func_rgb='hard')}


def pxg_inputs(torch, fv, tex, gen):
    """The common inputs of the pxg backward (K9) at 1024 px, K = 16,
    softmax and hard rgb: the pxg route's forward outputs (images, aggrs,
    threshold map) and a seeded incoming gradient, by the keys of PXG."""
    from jrender_tpu_torch.ops.softras import make_params, pxg_impl
    out = {}
    for key, kw in PXG.items():
        p = make_params(image_size=1024, **kw)
        img, ag, _, thr = pxg_impl.forward(pxg_impl.prep_pxg(fv, tex, p), p, True)
        out[key] = (img, ag, thr, torch.randn(img.shape, generator=gen, device=fv.device))
    return out


def thr_kernel(torch, pxg_impl, pin, depths, cnt, p, tile=None):
    """A callable that launches the pxg threshold kernel (K8) alone, its
    arguments made beforehand: on every tile (``tile`` None) or on that one
    global tile alone.  Through ``pxg_impl.thr_args`` where the tree has it;
    a tree whose wrapper finds the overfull tiles with a host read gets them
    here, before the timing, as its wrapper would (and ``tile`` alone)."""
    from jrender_tpu_torch.ops.softras import cuda_impl
    dev = pin.rows.device
    if hasattr(pxg_impl, 'thr_args'):
        args, *keep = pxg_impl.thr_args(pin, depths, cnt, p, *(() if tile is None else (tile, 1)))
    else:
        is_ = p.image_size
        over = (pxg_impl.overfull_tiles(pin, cnt, p) if tile is None else
                torch.tensor([tile], dtype=torch.int32, device=dev))
        thr = torch.full((pin.rows.shape[0], is_, is_), p.far, dtype=torch.float32, device=dev)
        args = pxg_impl._PxgThrArgs(
            pin.rows.data_ptr(), pin.entries.data_ptr(), pin.tile_off.data_ptr(),
            pin.item_off.data_ptr(), None if depths is None else depths.data_ptr(),
            over.data_ptr(), cnt.data_ptr(), thr.data_ptr(), over.numel(), pin.rows.shape[1],
            pin.rows.shape[2], is_, pxg_impl.tiles_for(is_),
            cuda_impl.chunk_for(cuda_impl.ROW_BASE), p.max_faces_id, p.dist_func_id,
            cuda_impl._scalars(p, pin.tex_res))
        keep = [over, thr]
    fn = cuda_impl._entry('softras_pxg_thr', 'softras_pxg_thr', pxg_impl._PxgThrArgs)

    def run():
        cuda_impl._run(fn, 'softras_pxg_thr', args, dev)
    run.keep = keep      # the tensors that args point into
    return run


def pxg_kernels(torch, fv, tex, common, times, timed, digest):
    """The pxg kernels of this tree on the faces at 1024 px: K7's partial
    rows and depth lists, the combine's outputs and K8's threshold from
    them, and K9's entry rows and face sums on the common inputs, as
    digests by key; adds to ``times`` each kernel's time on the softmax
    frame and K7's and K9's on the busiest tile's work items alone."""
    device_ms = _device_ms()
    from jrender_tpu_torch.ops.softras import make_params, pxg_impl, tiled
    out = {}
    for key, kw in PXG.items():
        p = make_params(image_size=1024, **kw)
        img_c, ag_c, thr_c, g = common[key]
        p40 = make_params(image_size=1024, max_faces_per_pixel_for_grad=40, **kw)
        pin = pxg_impl.prep_pxg(fv, tex, p, for_grad=True)
        parts, depths = pxg_impl.launch_pxg_fwd(pin, p, True)
        img, ag, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
        thr = pxg_impl.launch_pxg_thr(pin, depths, cnt, p)
        thr40 = pxg_impl.launch_pxg_thr(pin, None, cnt, p40)
        rows = pxg_impl.launch_pxg_bwd(pin, img_c, ag_c, thr_c, g, p)
        gf, gt = tiled.face_sum(pin, rows, p)
        torch.cuda.synchronize()
        out[key] = {'parts': digest(parts), 'depths': digest(depths), 'image': digest(img),
                    'aggrs': digest(ag), 'counts': digest(cnt), 'thr': digest(thr),
                    'thr_k40': digest(thr40), 'bwd_rows': digest(rows),
                    'bwd_face_sums': digest(gf, gt)}
        if key != 'pxg_softmax':
            continue
        # K8: the wrapper, and the kernel alone on every tile and on the
        # overfull tile of the most work items
        n_it = (pin.item_off[1:] - pin.item_off[:-1]).long()
        over = pxg_impl.overfull_tiles(pin, cnt, p).long()
        busy_o = int(over[n_it[over].argmax()])
        times.update({
            'pxg_thr_kernel_ms': timed(thr_kernel(torch, pxg_impl, pin, depths, cnt, p)),
            'pxg_thr_busiest_tile_ms': timed(thr_kernel(torch, pxg_impl, pin, depths, cnt, p,
                                                        busy_o)),
            'pxg_thr_k40_ms': timed(lambda: pxg_impl.launch_pxg_thr(pin, None, cnt, p40),
                                    reps=5),
            'pxg_overfull_tiles': over.numel(),
            'pxg_thr_busiest_tile_items': int(n_it[busy_o]),
            'pxg_fwd_ms': timed(lambda: pxg_impl.launch_pxg_fwd(pin, p, True)),
            'pxg_fwd_nothr_ms': timed(lambda: pxg_impl.launch_pxg_fwd(pin, p, False)),
            'pxg_combine_ms': timed(lambda: pxg_impl.launch_pxg_combine(pin, parts, p)),
            'pxg_thr_ms': timed(lambda: pxg_impl.launch_pxg_thr(pin, depths, cnt, p)),
            'pxg_bwd_ms': timed(lambda: pxg_impl.launch_pxg_bwd(pin, img_c, ag_c, thr_c, g, p)),
            'pxg_sum_ms': timed(lambda: tiled.face_sum(pin, rows, p)),
            'pxg_combine_device_ms': device_ms(
                alone(pxg_impl, 'combine_args', 'softras_pxg_fwd', 'softras_pxg_combine',
                      '_PxgCombineArgs', fv.device, pxg_impl.launch_pxg_combine, pin, parts, p),
                {'k': ('softras_pxg_combine_kernel',)})['k'],
            'pxg_sum_device_ms': device_ms(lambda: tiled.face_sum(pin, rows, p),
                                           {'k': ('segment_sum_kernel',)})['k'],
            'pxg_items': int(pin.items.shape[0])})
        # the busiest tile's items alone, on the frame's inputs
        busy = int((pin.tile_off[1:] - pin.tile_off[:-1]).argmax())
        pin_f = pin._replace(items=pin.items[pin.items[:, 0] == busy].contiguous())
        times.update({
            'pxg_fwd_busiest_tile_ms': timed(lambda: pxg_impl.launch_pxg_fwd(pin_f, p, True)),
            'pxg_fwd_nothr_busiest_tile_ms': timed(
                lambda: pxg_impl.launch_pxg_fwd(pin_f, p, False)),
            'pxg_bwd_busiest_tile_ms': timed(
                lambda: pxg_impl.launch_pxg_bwd(pin_f, img_c, ag_c, thr_c, g, p)),
            'pxg_busiest_tile_faces': int(pin.tile_off[busy + 1] - pin.tile_off[busy]),
            'pxg_busiest_tile_items': int(pin_f.items.shape[0])})
    return out


DIR_SPHERES = {'dir_288': (13, 12), 'dir_3330': (38, 45), 'dir_39474': (130, 153)}
DEMO2_VIEWS = 120


def reduce_inputs(torch, dev):
    """The reduction's more inputs by key: the 288- and 3,330-face spheres
    at 1024 px in the comparison's camera, 5x5 texels a face, and demo 2's
    first step (T = 1): face vertices, textures and the parameters'
    keywords."""
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.utils.primitives import uv_sphere
    _, _, _, renderer, gen = scene(torch, dev)
    out = {}
    for key, rs in (('red_288', (13, 12)), ('red_3330', (38, 45))):
        v, f = uv_sphere(*rs)
        tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
        with torch.no_grad():
            lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                       renderer.transform.eyes))
        out[key] = (lit.face_vertices.reshape(1, -1, 9).contiguous(),
                    lit.face_textures.contiguous(), dict(image_size=1024))
    out['red_demo2'] = demo2_inputs(torch, dev)
    return out


def reductions(torch, red_in, times, timed, digest):
    """The face reduction (``launch_reduce``) of this tree on the slot rows
    of each input of ``reduce_inputs`` (this tree's forward, threshold and
    backward, all-ones incoming gradient): the gradients as digests by key;
    adds to ``times`` the wrapper's time, the kernel's device time alone,
    the slot rows and their columns."""
    device_ms = _device_ms()
    from jrender_tpu_torch.ops.softras import cuda_impl, make_params
    out = {}
    for key, (fv, tex, kw) in red_in.items():
        p = make_params(**kw)
        inp = cuda_impl.prepare(fv, tex, p, for_grad=True)
        img, ag, cnt = cuda_impl.launch(inp, p)
        thr = cuda_impl.topk_threshold(fv, p, inp, cnt)
        rows = cuda_impl.launch_bwd(inp, img, ag, thr, torch.ones_like(img), p)
        out[key] = digest(*cuda_impl.launch_reduce(inp, rows, p))
        times.update({
            f'{key}_reduce_ms': timed(lambda: cuda_impl.launch_reduce(inp, rows, p)),
            f'{key}_reduce_device_ms': device_ms(
                alone(cuda_impl, 'reduce_args', 'softras_bwd', 'softras_bwd_reduce',
                      '_ReduceArgs', fv.device, cuda_impl.launch_reduce, inp, rows, p),
                {'k': ('softras_bwd_reduce_kernel',)})['k'],
            f'{key}_slot_rows': int(inp.lists.run_counts.sum()) + int(inp.lists.gcount.sum()),
            f'{key}_columns': rows.gslots.shape[2], f'{key}_views': fv.shape[0]})
    torch.cuda.synchronize()
    return out


def demo2_inputs(torch, dev):
    """The rasterizer's inputs of demo 2's first step (``chip_smoke.py``
    phase 7): 120 views at 64 px of the 1,300-face template, and its
    parameters."""
    import numpy as np
    from jrender_tpu_torch import Mesh, Renderer, deform
    from jrender_tpu_torch.ops.softras import make_params
    from jrender_tpu_torch.utils.primitives import uv_sphere
    v_s, f_s = uv_sphere(26, 26)
    v_s = v_s * np.float32(0.5 / 0.85)
    rng = np.random.RandomState(4)
    cams = (np.full(DEMO2_VIEWS, 2.732, np.float32),
            rng.uniform(-30, 60, DEMO2_VIEWS).astype(np.float32),
            rng.uniform(0, 360, DEMO2_VIEWS).astype(np.float32))
    trainer = Renderer(image_size=64, sigma_val=1e-4, aggr_func_rgb='hard',
                       camera_mode='look_at', viewing_angle=15, device=dev)
    trainer.transform.set_eyes_from_angles(*(torch.tensor(c, device=dev) for c in cams))
    model = deform.DeformModel(v_s, f_s).to(dev)
    with torch.no_grad():
        v0 = model.vertices()
        lit = trainer.transform(trainer.lighting(
            Mesh(v0.expand(DEMO2_VIEWS, -1, -1), model.faces.expand(DEMO2_VIEWS, -1, -1),
                 device=dev), trainer.transform.eyes))
    r = trainer.rasterizer
    kw = dict(image_size=r.image_size, background_color=r.background_color, near=r.near,
              far=r.far, fill_back=r.fill_back, eps=r.eps, sigma_val=r.sigma_val,
              dist_func=r.dist_func, dist_eps=r.dist_eps, gamma_val=r.gamma_val,
              aggr_func_rgb=r.aggr_func_rgb, aggr_func_alpha=r.aggr_func_alpha,
              texture_type=r.texture_type)
    return (lit.face_vertices.reshape(DEMO2_VIEWS, -1, 9).contiguous(),
            lit.face_textures.contiguous(), kw)


def dir_inputs(torch, dev, gen):
    """The dir part's four inputs by key: face vertices, textures, the
    parameters' keywords and the common inputs of both trees' backwards
    (this tree's forward outputs at K = 16 and a seeded incoming
    gradient)."""
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.ops.softras import dir_impl, make_params
    from jrender_tpu_torch.utils.primitives import uv_sphere
    out = {}
    _, _, _, renderer, _ = scene(torch, dev)
    for key, (rings, segs) in DIR_SPHERES.items():
        v, f = uv_sphere(rings, segs)
        tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
        with torch.no_grad():
            lit = renderer.transform(renderer.lighting(Mesh(v, f, textures=tex, texture_res=5),
                                                       renderer.transform.eyes))
        out[key] = (lit.face_vertices.reshape(1, -1, 9).contiguous(),
                    lit.face_textures.contiguous(), dict(image_size=1024))
    out['dir_demo2'] = demo2_inputs(torch, dev)
    for key, (fv, tex, kw) in out.items():
        p = make_params(**kw)
        img, ag, _, thr = dir_impl.launch_dir_fwd(dir_impl.prep_dir(fv, tex, p), p, True)
        out[key] += (img, ag, thr, torch.randn(img.shape, generator=gen, device=dev))
    return out


def live_items(torch, bbox, image_size, splits):
    """The (face, split) pairs with split < min(splits, chunks of 32 pixels
    in the face's pixel bbox): the backward's live work, counted here on
    its own from the bboxes (the rounding of ``bbox_pixels`` in
    csrc/softras_grad.cuh)."""
    isf = float(image_size)
    x0, x1, y0, y1 = bbox.unbind(-1)
    c0 = torch.floor((x0 * isf + isf - 1.0) * 0.5).clamp(0, isf)
    c1 = torch.ceil((x1 * isf + isf - 1.0) * 0.5).clamp(-1, isf - 1)
    r0 = torch.floor(((isf - 1.0) - y1 * isf) * 0.5).clamp(0, isf)
    r1 = torch.ceil(((isf - 1.0) - y0 * isf) * 0.5).clamp(-1, isf - 1)
    ok = (x0 <= x1) & (y0 <= y1) & (c0 <= c1) & (r0 <= r1)
    chunks = (((c1 - c0 + 1) * (r1 - r0 + 1)).long() + 31) // 32
    return int(torch.where(ok, chunks.clamp(max=splits), 0).sum())


def dir_kernels(torch, common, times, timed, digest):
    """The dir kernels of this tree on the four inputs: K10's outputs at K =
    16, 40 and without the threshold and K11's gradients at K = 16 and
    ``grad_mode='full'`` on the common inputs, as digests by input; adds to
    ``times`` each kernel's time, K11's launched warps, live items, partial
    rows' bytes and peak memory above the start around one call, and, where
    the tree waits on an item count, that wait in a step."""
    import dataclasses
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from jrender_tpu_torch.ops.softras import cuda_impl, dir_impl, make_params, soft_rasterize
    grad_prep = 'for_grad' in inspect.signature(dir_impl.prep_dir).parameters
    out = {}
    for key, (fv, tex, kw, img_c, ag_c, thr_c, g) in common.items():
        p = make_params(**kw)
        p40 = dataclasses.replace(p, max_faces_id=40)
        p_full = make_params(**kw, grad_mode='full')
        table = (dir_impl.prep_dir(fv, tex, p, for_grad=True) if grad_prep
                 else dir_impl.prep_dir(fv, tex, p))
        res = {}
        for tag, pp, thr_on in (('k16', p, True), ('k40', p40, True), ('nothr', p, False)):
            img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, pp, thr_on)
            res[f'fwd_{tag}'] = digest(img, ag, cnt, *(() if thr is None else (thr,)))
        for tag, pp, thr in (('k16', p, thr_c), ('full', p_full, None)):
            res[f'bwd_{tag}'] = digest(*dir_impl.launch_dir_bwd(table, img_c, ag_c, thr, g, pp))
        torch.cuda.synchronize()
        out[key] = res
        B, F = fv.shape[:2]
        is_ = p.image_size
        splits = max(1, min(is_ * is_ // dir_impl.SPLIT_PIXELS, dir_impl.MAX_SPLITS))
        GC = cuda_impl._grad_columns(p, table.tex_res)
        n_live = live_items(torch, table.bbox, is_, splits)
        if hasattr(dir_impl, 'item_count'):
            n_items = dir_impl.item_count(table.items)
            if n_items != n_live:
                raise AssertionError(f'{key}: the prep counts {n_items} items, the bboxes '
                                     f'{n_live}')
            launched, part = n_items, n_items * GC * 4
        else:
            launched, part = B * F * splits, B * F * splits * GC * 4
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        dir_impl.launch_dir_bwd(table, img_c, ag_c, thr_c, g, p)
        torch.cuda.synchronize()
        big = key == 'dir_39474'
        times.update({
            f'{key}_fwd_ms': timed(lambda: dir_impl.launch_dir_fwd(table, p, True)),
            f'{key}_fwd_nothr_ms': timed(lambda: dir_impl.launch_dir_fwd(table, p, False)),
            f'{key}_fwd_k40_ms': timed(lambda: dir_impl.launch_dir_fwd(table, p40, True),
                                       reps=2 if big else 5, rounds=3),
            f'{key}_bwd_ms': timed(lambda: dir_impl.launch_dir_bwd(table, img_c, ag_c, thr_c,
                                                                   g, p)),
            f'{key}_bwd_full_ms': timed(lambda: dir_impl.launch_dir_bwd(table, img_c, ag_c, None,
                                                                        g, p_full)),
            f'{key}_bwd_peak_bytes': torch.cuda.max_memory_allocated() - m0,
            f'{key}_bwd_part_bytes': part, f'{key}_bwd_launched_warps': launched,
            f'{key}_bwd_live_items': n_live, f'{key}_faces': F, f'{key}_views': B})
    # a dir soft_rasterize step on the 288-face sphere: device time, kernel
    # launches and the backward's wait on the item count
    fv, tex, kw = common['dir_288'][:3]
    fv_l = fv.detach().clone().requires_grad_(True)
    tex_l = tex.detach().clone().requires_grad_(True)

    def step():
        fv_l.grad = tex_l.grad = None
        soft_rasterize(fv_l, tex_l, **kw).sum().backward()

    with dir_impl.with_dir_max(4096):
        times['dir_288_step_ms'] = timed(step, reps=10)
        waits = []
        for _ in range(10):
            step()
            waits.append(getattr(dir_impl.launch_dir_bwd, 'wait_ms', float('nan')))
        times['dir_288_step_bwd_wait_ms'] = float(np.median(waits))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                step()
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    times['dir_288_step_device_ms'] = sum(e.self_device_time_total for e in ev) / 1e3 / 4
    times['dir_288_step_device_launches'] = sum(e.count for e in ev) / 4
    times['dir_288_step_kernels_device_ms'] = {e.key: e.self_device_time_total / 1e3 / 4
                                               for e in ev if 'softras' in e.key}
    return out


PARTS = ('binned', 'tiled', 'pxg', 'n3mr', 'dir')


def worker(repo: str, inputs: str, out: str, make: bool, parts) -> int:
    """One tree's run, in a process that imports that tree only."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(repo).resolve()))
    from jrender_tpu_torch import Mesh
    from jrender_tpu_torch.ops.softras import binning, cuda_impl, make_params

    device_ms = _device_ms()

    dev = torch.device('cuda')
    p = make_params(image_size=1024)
    if make:
        made = {}
        if set(parts) - {'dir'}:
            v, f, tex, renderer, gen = scene(torch, dev)
            mesh = Mesh(v, f, textures=tex, texture_res=5)
            with torch.no_grad():
                lit = renderer.transform(renderer.lighting(mesh, renderer.transform.eyes))
            fv = lit.face_vertices.reshape(1, -1, 9).contiguous()
            tex = lit.face_textures.contiguous()
            inp = cuda_impl.prepare(fv, tex, p, for_grad=True)
            img, ag, cnt = cuda_impl.launch(inp, p)
            thr = cuda_impl.launch_thr(inp, cnt, p)
            g = torch.randn(img.shape, generator=gen, device=dev)
            made.update({'fv': fv, 'tex': tex, 'img': img, 'ag': ag, 'cnt': cnt, 'thr': thr,
                         'g': g, 'n3mr_in': n3mr_inputs(torch, dev, v, f, gen),
                         'tiled_bwd_in': tiled_bwd_inputs(torch, fv, tex, gen),
                         'pxg_in': pxg_inputs(torch, fv, tex, gen)})
        if 'n3mr' in parts:
            made['tex_in'] = tex_inputs(torch, dev, torch.Generator(device=dev).manual_seed(14))
        if 'binned' in parts:
            made['red_in'] = reduce_inputs(torch, dev)
        if 'dir' in parts:
            made['dir_in'] = dir_inputs(torch, dev, torch.Generator(device=dev).manual_seed(13))
        torch.save(made, inputs)
        return 0

    d = torch.load(inputs, map_location=dev)
    fv, tex = d.get('fv'), d.get('tex')

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

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

    times, res = {}, {}
    if 'binned' in parts:
        inp = cuda_impl.prepare(fv, tex, p, for_grad=True)
        img, ag, cnt = cuda_impl.launch(inp, p)
        thr = cuda_impl.launch_thr(inp, d['cnt'], p)
        p40 = make_params(image_size=1024, max_faces_per_pixel_for_grad=40)
        thr40 = cuda_impl.launch_thr(inp, d['cnt'], p40)
        rows = cuda_impl.launch_bwd(inp, d['img'], d['ag'], d['thr'], d['g'], p)
        gf, gt = cuda_impl.launch_reduce(inp, rows, p)
        torch.cuda.synchronize()
        n = int(inp.lists.run_counts.sum())
        nb = int(inp.lists.gcount.sum())
        ones = torch.ones_like(img)
        times.update({
            'fwd_ms': timed(lambda: cuda_impl.launch(inp, p)),
            'thr_ms': timed(lambda: cuda_impl.launch_thr(inp, cnt, p)),
            'thr_k40_ms': timed(lambda: cuda_impl.launch_thr(inp, cnt, p40), reps=5),
            'bwd_ms': timed(lambda: cuda_impl.launch_bwd(inp, img, ag, d['thr'], ones, p)),
            'reduce_ms': timed(lambda: cuda_impl.launch_reduce(inp, rows, p)),
            'reduce_device_ms': device_ms(
                alone(cuda_impl, 'reduce_args', 'softras_bwd', 'softras_bwd_reduce',
                      '_ReduceArgs', dev, cuda_impl.launch_reduce, inp, rows, p),
                {'k': ('softras_bwd_reduce_kernel',)})['k']})
        busiest = int(inp.lists.counts[0].argmax())
        ids = binning.tile_list(inp.lists, 0, busiest, -(-1024 // cuda_impl.TILE)).long()
        sub = cuda_impl.prepare(fv[:, ids].contiguous(), tex[:, ids].contiguous(), p,
                                for_grad=True)
        img_s, ag_s, cnt_s = cuda_impl.launch(sub, p)
        thr_s = cuda_impl.launch_thr(sub, cnt_s, p)
        times['fwd_busiest_tile_alone_ms'] = timed(lambda: cuda_impl.launch(sub, p))
        times['thr_busiest_tile_alone_ms'] = timed(lambda: cuda_impl.launch_thr(sub, cnt_s, p))
        times['bwd_busiest_tile_alone_ms'] = timed(
            lambda: cuda_impl.launch_bwd(sub, img_s, ag_s, thr_s, torch.ones_like(img_s), p))
        res.update({'img': img, 'ag': ag, 'cnt': cnt, 'thr': thr, 'thr40': thr40,
                    'busiest_faces': ids.numel(),
                    'slot_rows': digest(rows.gslots[:, :n], rows.gbig[:, :nb]),
                    'reduced': digest(gf, gt),
                    'reduced_more': reductions(torch, d['red_in'], times, timed, digest)})
    if 'tiled' in parts:
        res['tiled'] = tiled_forwards(torch, fv, tex, times, timed)
        res['tiled_bwd'] = tiled_backwards(torch, fv, tex, d['tiled_bwd_in'], times, timed,
                                           digest)
    if 'pxg' in parts:
        res['pxg'] = pxg_kernels(torch, fv, tex, d['pxg_in'], times, timed, digest)
    if 'dir' in parts:
        res['dir'] = dir_kernels(torch, d['dir_in'], times, timed, digest)
    if 'n3mr' in parts:
        from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
        fv_n, tex_n, edge_in = d['n3mr_in']
        res['maps'], res['n3mr_census'] = n3mr_maps(torch, fv_n, tex_n, times, timed, digest)
        res['edge'] = ncuda.launch_edgebwd(*edge_in, N3MR_EPS, True, False)
        times['n3mr_edgebwd_ms'] = timed(
            lambda: ncuda.launch_edgebwd(*edge_in, N3MR_EPS, True, False))
        times['n3mr_edge_bands_device_ms'] = device_ms(
            alone(ncuda, 'edge_bands_args', 'n3mr_edgebwd', 'n3mr_edge_bands', '_EdgeBandArgs',
                  dev, ncuda.launch_edge_bands, edge_in[0], 1024),
            {'k': ('n3mr_edge_bands_kernel',)})['k']
        res['texbwd'] = texbwd(torch, d['tex_in'], times, timed, digest)
    if set(parts) - {'dir', 'n3mr'}:
        times.update(step_times(torch, np, fv, tex, timed, parts))
    torch.save({**res, 'times': times}, out)
    return 0


def agreement(par, chg, turns, first, parts):
    """Whether the two trees' outputs agree, bit for bit where they should,
    and each tree's turns with each other."""
    import torch
    same = {}
    if 'tiled' in parts:
        def tiled_agree(a, b):
            """The f_px and px_f forwards of two runs: counts, winners and
            thresholds bit for bit, the largest image difference."""
            res = {}
            for key in a:
                (ia, ga, ca, ta), (ib, gb, cb, tb) = a[key], b[key]
                res[f'{key}_counts_equal'] = torch.equal(ca, cb)
                if key.endswith('hard'):
                    res[f'{key}_winners_equal'] = torch.equal(ga, gb)
                if ta is not None:
                    res[f'{key}_thr_equal'] = torch.equal(ta, tb)
                res[f'{key}_image_max_abs_diff'] = (ia - ib).abs().max().item()
            return res

        same.update({
            **tiled_agree(par['tiled'], chg['tiled']),
            'tiled_each_tree_twice_equal': all(
                all(v for k, v in tiled_agree(r['tiled'], first[t]['tiled']).items()
                    if k.endswith('equal')) and
                all(torch.equal(x[0], y[0]) for x, y in zip(r['tiled'].values(),
                                                            first[t]['tiled'].values()))
                for t, r in turns),
            **{f'{k}_bwd_rows_equal': par['tiled_bwd'][k]['rows'] == chg['tiled_bwd'][k]['rows']
               for k in TILED_BWD},
            **{f'{k}_bwd_face_sums_equal':
               par['tiled_bwd'][k]['sums'] == chg['tiled_bwd'][k]['sums'] for k in TILED_BWD},
            'tiled_bwd_each_tree_twice_equal': all(r['tiled_bwd'] == first[t]['tiled_bwd']
                                                   for t, r in turns)})
    if 'pxg' in parts:
        same.update({f'{k}_{what}_equal': par['pxg'][k][what] == chg['pxg'][k][what]
                     for k in PXG for what in par['pxg'][k]})
        same['pxg_each_tree_twice_equal'] = all(r['pxg'] == first[t]['pxg'] for t, r in turns)
    if 'binned' in parts:
        same.update({
            'fwd_counts_equal': torch.equal(par['cnt'], chg['cnt']),
            'fwd_image_equal': torch.equal(par['img'], chg['img']),
            'fwd_aggrs_equal': torch.equal(par['ag'], chg['ag']),
            'fwd_softmax_max_equal': torch.equal(par['ag'][:, 1], chg['ag'][:, 1]),
            'fwd_image_max_abs_diff': (par['img'] - chg['img']).abs().max().item(),
            'fwd_aggr_S_max_rel_diff': ((par['ag'][:, 0] - chg['ag'][:, 0]).abs()
                                        / par['ag'][:, 0].abs()).max().item(),
            'thr_equal': torch.equal(par['thr'], chg['thr']),
            'thr_k40_equal': torch.equal(par['thr40'], chg['thr40']),
            'bwd_slot_rows_equal': par['slot_rows'] == chg['slot_rows'],
            'bwd_reduced_equal': par['reduced'] == chg['reduced'],
            **{f'{k}_reduced_equal': par['reduced_more'][k] == chg['reduced_more'][k]
               for k in par['reduced_more']},
            'reduced_each_tree_twice_equal': all(
                (r['reduced'], r['reduced_more']) == (first[t]['reduced'], first[t]['reduced_more'])
                for t, r in turns),
            'each_tree_twice_equal': all(r['slot_rows'] == first[t]['slot_rows']
                                         and torch.equal(r['img'], first[t]['img'])
                                         and torch.equal(r['thr'], first[t]['thr'])
                                         and torch.equal(r['thr40'], first[t]['thr40'])
                                         for t, r in turns)})
    if 'dir' in parts:
        same.update({f'{k}_{what}_equal': par['dir'][k][what] == chg['dir'][k][what]
                     for k in par['dir'] for what in par['dir'][k]})
        same['dir_each_tree_twice_equal'] = all(r['dir'] == first[t]['dir'] for t, r in turns)
    if 'n3mr' in parts:
        same.update({f'n3mr_{k}_equal': par['maps'][k] == chg['maps'][k] for k in MAPS})
        same['n3mr_maps_each_tree_twice_equal'] = all(r['maps'] == first[t]['maps']
                                                      for t, r in turns)
        same.update({f'{k}_texbwd_equal': par['texbwd'][k] == chg['texbwd'][k]
                     for k in par['texbwd']})
        same['texbwd_each_tree_twice_equal'] = all(r['texbwd'] == first[t]['texbwd']
                                                   for t, r in turns)
        same['edge_each_tree_twice_equal'] = all(torch.equal(r['edge'], first[t]['edge'])
                                                 for t, r in turns)
        same['edge_max_diff_of_scale'] = ((par['edge'] - chg['edge']).abs().max()
                                          / par['edge'].abs().max()).item()
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', help='the other tree of the port')
    ap.add_argument('--change', default=str(REPO), help='the tree held against it (this one)')
    ap.add_argument('--parts', default=','.join(PARTS),
                    help=f'comma-separated parts to run, of {",".join(PARTS)}')
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    ap.add_argument('--inputs', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    ap.add_argument('--make', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = [x for x in args.parts.split(',') if x]
    if not parts or any(x not in PARTS for x in parts):
        ap.error(f'--parts takes some of {",".join(PARTS)}, got {args.parts!r}')
    import torch
    if not torch.cuda.is_available():
        print('compare_softras_trees: no CUDA device', file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker, args.inputs, args.out, args.make, parts)
    if not args.parent:
        ap.error('--parent is required')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    trees = {'parent': str(Path(args.parent).resolve()),
             'change': str(Path(args.change).resolve())}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = f'{tmp}/inputs.pt'

        def run(tree, out, make=False):
            cmd = [sys.executable, __file__, '--worker', trees[tree], '--inputs', inputs,
                   '--out', out, '--parts', ','.join(parts)] + (['--make'] if make else [])
            subprocess.run(cmd, check=True)

        run('change', '', make=True)
        turns = []
        for i, tree in enumerate(('parent', 'change', 'change', 'parent')):
            run(tree, f'{tmp}/{i}.pt')
            turns.append((tree, torch.load(f'{tmp}/{i}.pt')))
    first = {tree: r for tree, r in reversed(turns)}
    same = agreement(first['parent'], first['change'], turns, first, parts)
    print(json.dumps({'device': smi, 'trees': trees, 'parts': parts,
                      'busiest_tile_faces': first['change'].get('busiest_faces'),
                      'n3mr_census': first['change'].get('n3mr_census'),
                      'agree': same,
                      'turns': [{'tree': t, **r['times']} for t, r in turns]}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
