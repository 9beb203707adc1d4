#!/usr/bin/env python3
"""Where the time of the port's render and training paths goes, on one
CUDA card.

    python3 tools/profile_torch_render.py

Renders demo 1's camera at 1024 px on bench.py's UV spheres (288, 3,330
and 39,474 faces, 5x5 texels per face) with
``jrender_tpu_torch.Renderer`` and prints, one JSON object per line:

  * ``stages``: each stage of one frame timed alone with CUDA events
    (lighting, transform, binning, row prep, kernel), per mesh, and the
    stages of the backward (binning with the sort's inverse, threshold,
    backward and reduction kernels, the forward + backward step of
    ``soft_rasterize`` and of ``render_mesh``);
  * ``profile``: torch.profiler over 4 frames of the 39,474-face mesh:
    device time by kernel name, and its share of the (unprofiled)
    ``render_mesh`` wall time; ``profile_step``: the same over 4 forward +
    backward steps through ``render_mesh``;
  * ``tail``: each kernel on the faces of the busiest tile alone, whose
    one block is the critical path of the full frame;
  * ``n3mr_stages``: the stages of the N3MR step on the 39,474-face mesh
    (2x2x2 texels per face), each timed alone: binning, per-face rows, the
    z-buffer kernel with and without the texture fetch, the edge kernel's
    inputs (plain torch) and the edge kernel (both axes in one launch),
    the texture-gradient kernel, the depth gradient (plain torch), and the
    forward + backward step of ``rasterize``; ``n3mr_profile_step``:
    torch.profiler over 4 such steps (launches, device busy share);
  * ``dir_stages``: the dir route (``JR_DIR_MAX``) on the 288-face mesh:
    its prep (plain torch), the forward kernel with and without the top-K
    threshold, the backward kernel, and the ``soft_rasterize`` step, the
    ``render_mesh`` step and frame on both routes in turns (binned, dir,
    dir, binned); ``dir_small_profile``/``_step``/``_raster_step`` and
    ``binned_small_profile``/``_step``/``_raster_step``: torch.profiler
    over 4 frames, 4 ``render_mesh`` steps and 4 ``soft_rasterize`` steps of
    that mesh on each route (launches, device busy share);
  * ``dir_crossover``: the ``soft_rasterize`` and ``render_mesh`` steps of
    spheres of 9,940, 19,800 and 39,474 faces on both routes in turns, to
    find the face count where the dir route stops paying.
  * ``pxg_stages``: the pxg route (``JR_LAYOUT=pxg``) on the 39,474-face
    mesh: its prep (the binned route's binning and rows, then the work
    items), the partials kernel with and without the depth lists, the
    combine, the threshold, the backward and the face sum, each timed
    alone; each kernel on the busiest tile's items alone; the
    ``soft_rasterize`` step, the ``render_mesh`` step and frame on both
    routes in turns (binned, pxg, pxg, binned); ``pxg_group``: the kernels
    at work items of 16 to 256 faces and of whole tiles; ``pxg_profile``
    /``_step``/``_raster_step`` and ``binned_profile_raster_step``:
    torch.profiler over 4 frames, 4 ``render_mesh`` steps and 4
    ``soft_rasterize`` steps (launches, device busy share).

Seeded; needs a card (exits 2 without one) and nvcc.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_render: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from jrender_tpu_torch import Mesh, Renderer
    from jrender_tpu_torch.ops.softras import (binning, cuda_impl, make_params,
                                               soft_rasterize)
    from jrender_tpu_torch.utils.primitives import uv_sphere

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1]) / reps

    def scene(rings, segs):
        v, f = uv_sphere(rings, segs)
        gen.manual_seed(0)
        tex = torch.rand((1, f.shape[0], 25, 3), generator=gen, device=dev)
        mesh = Mesh(v, f, textures=tex, texture_res=5)
        renderer = Renderer(image_size=1024)
        renderer.transform.set_eyes_from_angles(2.732, 30, 45)
        return mesh, renderer

    p = make_params(image_size=1024)
    for rings, segs in ((13, 12), (38, 45), (130, 153)):
        mesh, r = scene(rings, segs)
        eyes = r.transform.eyes

        def light():
            mesh.reset_()
            return r.lighting(mesh, eyes)

        lit, t_light = timed(light)
        orig_vertices = mesh.vertices

        def transform():
            mesh.vertices = orig_vertices
            return r.transform(mesh)

        _, t_tf = timed(transform)
        fv = mesh.face_vertices.reshape(1, -1, 9).contiguous()
        tex = mesh.face_textures.contiguous()
        lists, t_bin = timed(lambda: binning.build_tile_lists_compact(
            fv, 1024, cuda_impl.TILE, cuda_impl.TILE, p.threshold))
        rows, t_rows = timed(lambda: cuda_impl.face_rows(fv, tex, p))
        inputs = cuda_impl.FwdInputs(rows, lists, 5)
        (img, ag, cnt), t_kernel = timed(lambda: cuda_impl.launch(inputs, p), reps=30)

        # the backward's stages, each alone
        lists_g, t_bin_g = timed(lambda: binning.build_tile_lists_compact(
            fv, 1024, cuda_impl.TILE, cuda_impl.TILE, p.threshold, with_inverse=True))
        inputs_g = cuda_impl.FwdInputs(rows, lists_g, 5)
        thr, t_thr = timed(lambda: cuda_impl.launch_thr(inputs_g, cnt, p), reps=30)
        g_img = torch.ones_like(img)
        grad_rows, t_bwd = timed(lambda: cuda_impl.launch_bwd(inputs_g, img, ag, thr, g_img, p),
                                 reps=30)
        _, t_red = timed(lambda: cuda_impl.launch_reduce(inputs_g, grad_rows, p), reps=30)
        fv_leaf = fv.detach().clone().requires_grad_(True)
        tex_leaf = tex.detach().clone().requires_grad_(True)

        def raster_step():
            fv_leaf.grad = tex_leaf.grad = None
            soft_rasterize(fv_leaf, tex_leaf, image_size=1024).sum().backward()

        _, t_step = timed(raster_step)
        v_leaf = mesh._origin_vertices.detach().clone().requires_grad_(True)
        t_leaf = mesh._origin_textures.detach().clone().requires_grad_(True)
        mesh_g = Mesh(v_leaf, mesh._origin_faces, textures=t_leaf, texture_res=5)

        def render_step():
            v_leaf.grad = t_leaf.grad = None
            mesh_g.reset_()
            alpha, rgb = r.render_mesh(mesh_g, mode=None)
            (alpha.sum() + rgb.sum()).backward()

        render_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            render_step()
        torch.cuda.synchronize()
        t_render_step = (time.perf_counter() - t0) * 100

        def frame():
            mesh.reset_()
            return r.render_mesh(mesh, mode='rgb')

        t0 = time.perf_counter()
        for _ in range(10):
            frame()
        torch.cuda.synchronize()
        t_frame = (time.perf_counter() - t0) * 100
        counts = lists.counts[lists.counts > 0].float()
        print(json.dumps({'stages': {
            'faces': fv.shape[1], 'lighting_ms': t_light, 'transform_ms': t_tf,
            'binning_ms': t_bin, 'rows_ms': t_rows, 'kernel_ms': t_kernel,
            'render_mesh_ms': t_frame,
            'binning_with_inverse_ms': t_bin_g, 'thr_kernel_ms': t_thr,
            'bwd_kernel_ms': t_bwd, 'reduce_kernel_ms': t_red,
            'soft_rasterize_step_ms': t_step, 'render_mesh_step_ms': t_render_step,
            'pixels_over_K': int((cnt > p.max_faces_id).sum().item()),
            'covered_tiles': int(counts.numel()),
            'tile_face_pairs': int(counts.sum().item()),
            'busiest_tile': int(counts.max().item()),
            'mean_covered_tile': counts.mean().item()}}), flush=True)

    # torch.profiler over frames of the large mesh: device time by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    def profiled(tag, fn, wall_ms):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(((e.self_device_time_total / 1e3 / 4, e.count // 4, e.key[:70])
                          for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                         reverse=True)
        busy = sum(k[0] for k in kernels)
        print(json.dumps({tag: {
            'frames': 4, 'device_ms_per_frame': busy,
            'kernel_launches_per_frame': sum(k[1] for k in kernels),
            'wall_ms_per_frame': wall_ms, 'device_busy_share': busy / wall_ms,
            'top': [{'ms_per_frame': k[0], 'calls_per_frame': k[1], 'name': k[2]}
                    for k in kernels[:12]]}}), flush=True)

    profiled('profile', frame, t_frame)
    profiled('profile_step', render_step, t_render_step)

    # the busiest tile's faces alone against the full frame, in turns on
    # the same card: the busiest tile's block is the full frame's tail
    busiest = int(lists.counts[0].argmax())
    ids = binning.tile_list(lists, 0, busiest, 1024 // cuda_impl.TILE).long()
    sub = cuda_impl.prepare(fv[:, ids].contiguous(), tex[:, ids].contiguous(), p,
                            for_grad=True)
    img_s, ag_s, cnt_s = cuda_impl.launch(sub, p)
    thr_s = cuda_impl.launch_thr(sub, cnt_s, p)
    both = {'full': (inputs_g, img, ag, cnt, thr), 'tail': (sub, img_s, ag_s, cnt_s, thr_s)}
    turns = {k: {'full': [], 'tail': []} for k in ('fwd', 'thr', 'bwd')}
    for which in ('full', 'tail', 'tail', 'full', 'full', 'tail'):
        i, im, a, c, th = both[which]
        turns['fwd'][which].append(timed(lambda: cuda_impl.launch(i, p), reps=30)[1])
        turns['thr'][which].append(timed(lambda: cuda_impl.launch_thr(i, c, p), reps=30)[1])
        turns['bwd'][which].append(timed(
            lambda: cuda_impl.launch_bwd(i, im, a, th, g_img, p), reps=30)[1])
    print(json.dumps({'tail': {
        'busiest_tile_faces': int(ids.numel()),
        'kernel_ms_busiest_tile_alone': turns['fwd']['tail'],
        'kernel_ms_full_frame': turns['fwd']['full'],
        'thr_ms_busiest_tile_alone': turns['thr']['tail'],
        'thr_ms_full_frame': turns['thr']['full'],
        'bwd_ms_busiest_tile_alone': turns['bwd']['tail'],
        'bwd_ms_full_frame': turns['bwd']['full']}}), flush=True)
    # the N3MR step on the same mesh: bench.py's n3mr_row
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain, rasterize
    from jrender_tpu_torch.structures import face_vertices
    from jrender_tpu_torch.transform import look_at, perspective
    v, f = uv_sphere(130, 153)
    vt = perspective(look_at(torch.tensor(v, device=dev)[None], (0.0, 0.0, -2.732)), angle=30)
    face = face_vertices(vt, torch.tensor(f, device=dev)[None]).reshape(1, -1, 9).contiguous()
    gen.manual_seed(1)
    tex3 = torch.rand((1, face.shape[1], 2, 2, 2, 3), generator=gen, device=dev)
    eps = 1e-4
    n_lists, t_nbin = timed(lambda: ncuda.tile_lists(face, 1024))
    n_rows, t_nrows = timed(lambda: nplain.face_rows(face, 1024))
    maps, t_maps = timed(lambda: ncuda.launch_maps(n_rows, n_lists, tex3, 1024, 0.1, 100.0, eps),
                         reps=30)
    _, t_maps_notex = timed(lambda: ncuda.launch_maps(n_rows, n_lists, None, 1024, 0.1, 100.0,
                                                      eps), reps=30)
    fi, wt, dp, finv, zc, rgb = maps
    alpha = (fi >= 0).float()
    g_rgb = torch.ones_like(rgb)
    edge_in, t_edge_in = timed(lambda: ncuda.edge_inputs(face, fi, rgb, alpha, g_rgb, alpha,
                                                         1024, True, False))
    _, t_edge = timed(lambda: ncuda.launch_edgebwd(*edge_in, eps, True, False), reps=30)
    _, t_tex = timed(lambda: ncuda.launch_texbwd(n_rows, tex3.shape, fi, wt, dp, zc, g_rgb, eps),
                     reps=30)
    _, t_depth = timed(lambda: nplain.backward_depth(face, fi, finv, wt, dp, zc, alpha))
    face_leaf = face.reshape(1, -1, 3, 3).clone().requires_grad_(True)
    tex_leaf3 = tex3.clone().requires_grad_(True)

    def n3mr_step():
        face_leaf.grad = tex_leaf3.grad = None
        rasterize(face_leaf, tex_leaf3, image_size=1024, anti_aliasing=False).sum().backward()

    _, t_nstep = timed(n3mr_step)
    t0 = time.perf_counter()
    for _ in range(10):
        n3mr_step()
    torch.cuda.synchronize()
    t_nstep_wall = (time.perf_counter() - t0) * 100
    e_rows, out_cells, in_cells, longest, positive = nplain.edge_scan_census(
        face, fi, 1024, [[(rgb[0, ..., k], g_rgb[0, ..., k]) for k in range(3)]])
    print(json.dumps({'n3mr_stages': {
        'faces': face.shape[1], 'binning_ms': t_nbin, 'rows_ms': t_nrows,
        'maps_kernel_ms': t_maps, 'maps_kernel_without_textures_ms': t_maps_notex,
        'edge_inputs_ms': t_edge_in, 'edge_kernel_ms': t_edge, 'texbwd_kernel_ms': t_tex,
        'depth_gradient_ms': t_depth, 'rasterize_step_ms': t_nstep,
        'rasterize_step_wall_ms': t_nstep_wall,
        'busiest_tile': int(n_lists.counts.max().item()),
        'drawn_pixels': int((fi >= 0).sum().item()), 'edge_rows': e_rows,
        'edge_cells_out': out_cells, 'edge_cells_in': in_cells,
        'edge_cells_positive': positive, 'edge_longest_item_cells': longest}}), flush=True)
    profiled('n3mr_profile_step', n3mr_step, t_nstep_wall)

    # the dir route on the 288-face mesh (bench.py's small row), with the
    # binned route's frame and step beside it, in turns on the same card
    from jrender_tpu_torch.ops.softras import dir_impl

    def wall(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def route_steps(rings, segs):
        """The lit mesh's face table and its soft_rasterize step,
        render_mesh step and frame, for either route."""
        mesh, r = scene(rings, segs)
        with torch.no_grad():
            lit = r.transform(r.lighting(mesh, r.transform.eyes))
        fv = lit.face_vertices.reshape(1, -1, 9).contiguous()
        tex = lit.face_textures.contiguous()
        fv_leaf = fv.detach().clone().requires_grad_(True)
        tex_leaf = tex.detach().clone().requires_grad_(True)
        v_leaf = mesh._origin_vertices.detach().clone().requires_grad_(True)
        t_leaf = mesh._origin_textures.detach().clone().requires_grad_(True)
        mesh_g = Mesh(v_leaf, mesh._origin_faces, textures=t_leaf, texture_res=5)

        def raster_step():
            fv_leaf.grad = tex_leaf.grad = None
            soft_rasterize(fv_leaf, tex_leaf, image_size=1024).sum().backward()

        def render_step():
            v_leaf.grad = t_leaf.grad = None
            mesh_g.reset_()
            alpha, rgb = r.render_mesh(mesh_g, mode=None)
            (alpha.sum() + rgb.sum()).backward()

        def frame():
            mesh.reset_()
            return r.render_mesh(mesh, mode='rgb')

        return fv, tex, raster_step, render_step, frame

    def in_turns(F, raster_step, render_step, frame=None):
        """Each step on both routes in turns: binned, dir, dir, binned."""
        routes = {'binned': {}, 'dir': {}}
        for route in ('binned', 'dir', 'dir', 'binned'):
            with dir_impl.with_dir_max(F if route == 'dir' else 0):
                got = routes[route]
                got.setdefault('soft_rasterize_step_ms', []).append(timed(raster_step)[1])
                got.setdefault('render_mesh_step_ms', []).append(wall(render_step))
                if frame is not None:
                    got.setdefault('render_mesh_ms', []).append(wall(frame))
        return routes

    fv, tex, raster_step, render_step, frame = route_steps(13, 12)
    F = fv.shape[1]
    table, t_prep = timed(lambda: dir_impl.prep_dir(fv, tex, p, for_grad=True))
    (img, ag, cnt, thr), t_dfwd_thr = timed(lambda: dir_impl.launch_dir_fwd(table, p, True),
                                            reps=30)
    _, t_dfwd = timed(lambda: dir_impl.launch_dir_fwd(table, p, False), reps=30)
    _, t_dbwd = timed(lambda: dir_impl.launch_dir_bwd(table, img, ag, thr, torch.ones_like(img),
                                                      p), reps=30)
    routes = in_turns(F, raster_step, render_step, frame)
    print(json.dumps({'dir_stages': {
        'faces': F, 'prep_ms': t_prep, 'fwd_kernel_ms': t_dfwd,
        'fwd_thr_kernel_ms': t_dfwd_thr, 'bwd_kernel_ms': t_dbwd,
        'pixels_over_K': int((cnt > p.max_faces_id).sum().item()),
        'routes_in_turns': routes}}), flush=True)
    for route in ('dir', 'binned'):
        with dir_impl.with_dir_max(F if route == 'dir' else 0):
            profiled(f'{route}_small_profile', frame, min(routes[route]['render_mesh_ms']))
            profiled(f'{route}_small_profile_step', render_step,
                     min(routes[route]['render_mesh_step_ms']))
            profiled(f'{route}_small_profile_raster_step', raster_step,
                     min(routes[route]['soft_rasterize_step_ms']))

    # where the routes cross: the steps of larger spheres on both routes
    for rings, segs in ((71, 71), (100, 100), (130, 153)):
        fv, _, raster_step, render_step, _ = route_steps(rings, segs)
        print(json.dumps({'dir_crossover': {
            'faces': fv.shape[1],
            'routes_in_turns': in_turns(fv.shape[1], raster_step, render_step)}}), flush=True)
        del raster_step, render_step
        torch.cuda.empty_cache()

    # the pxg route on the 39,474-face mesh
    from jrender_tpu_torch.ops.softras import pxg_impl, route as sroute, tiled
    fv, tex, raster_step, render_step, frame = route_steps(130, 153)
    _, t_base = timed(lambda: cuda_impl.prepare(fv, tex, p, for_grad=False))
    _, t_base_g = timed(lambda: cuda_impl.prepare(fv, tex, p, for_grad=True))

    def pxg_kernels(group):
        """Each pxg kernel alone at work items of ``group`` faces; and
        each on the busiest tile's items alone."""
        pin, t_prep = timed(lambda: pxg_impl.prep_pxg(fv, tex, p, for_grad=True, group=group))
        (parts, depths), t_fwd = timed(lambda: pxg_impl.launch_pxg_fwd(pin, p, True), reps=30)
        _, t_fwd_nothr = timed(lambda: pxg_impl.launch_pxg_fwd(pin, p, False), reps=30)
        (img, ag, cnt), t_comb = timed(lambda: pxg_impl.launch_pxg_combine(pin, parts, p),
                                       reps=30)
        thr, t_thr = timed(lambda: pxg_impl.launch_pxg_thr(pin, depths, cnt, p), reps=30)
        g1 = torch.ones_like(img)
        grows, t_bwd = timed(lambda: pxg_impl.launch_pxg_bwd(pin, img, ag, thr, g1, p), reps=30)
        _, t_sum = timed(lambda: tiled.face_sum(pin, grows, p), reps=30)
        off = pin.item_off.long()
        faces_t = (pin.tile_off[1:] - pin.tile_off[:-1]).long()
        busy = int(faces_t.argmax().item())
        tail = pin._replace(items=pin.items[off[busy]:off[busy + 1]].contiguous())
        _, t_fwd_tail = timed(lambda: pxg_impl.launch_pxg_fwd(tail, p, True), reps=30)
        _, t_bwd_tail = timed(lambda: pxg_impl.launch_pxg_bwd(tail, img, ag, thr, g1, p),
                              reps=30)
        return {'group': group, 'items': pin.items.shape[0], 'entries': pin.entries.numel(),
                'busiest_tile_faces': int(faces_t[busy].item()),
                'busiest_tile_items': int((off[busy + 1] - off[busy]).item()),
                'prep_ms': t_prep, 'fwd_kernel_ms': t_fwd, 'fwd_nothr_kernel_ms': t_fwd_nothr,
                'combine_kernel_ms': t_comb, 'thr_kernel_ms': t_thr, 'bwd_kernel_ms': t_bwd,
                'sum_kernel_ms': t_sum, 'fwd_kernel_busiest_tile_ms': t_fwd_tail,
                'bwd_kernel_busiest_tile_ms': t_bwd_tail,
                'overfull_tiles': int(pxg_impl.overfull_tiles(pin, cnt, p).numel())}

    stages = pxg_kernels(pxg_impl.GROUP)
    routes = {'binned': {}, 'pxg': {}}
    for name in ('binned', 'pxg', 'pxg', 'binned'):
        with sroute.with_layout('pxg' if name == 'pxg' else 'pxt'):
            got = routes[name]
            got.setdefault('soft_rasterize_step_ms', []).append(timed(raster_step)[1])
            got.setdefault('render_mesh_step_ms', []).append(wall(render_step))
            got.setdefault('render_mesh_ms', []).append(wall(frame))
    print(json.dumps({'pxg_stages': {
        'faces': fv.shape[1], 'binning_and_rows_ms': t_base,
        'binning_with_inverse_and_rows_ms': t_base_g, **stages,
        'routes_in_turns': routes}}), flush=True)
    for group in (16, 32, 128, 256, 2048):
        print(json.dumps({'pxg_group': pxg_kernels(group)}), flush=True)
    with sroute.with_layout('pxg'):
        profiled('pxg_profile', frame, min(routes['pxg']['render_mesh_ms']))
        profiled('pxg_profile_step', render_step, min(routes['pxg']['render_mesh_step_ms']))
        profiled('pxg_profile_raster_step', raster_step,
                 min(routes['pxg']['soft_rasterize_step_ms']))
    profiled('binned_profile_raster_step', raster_step,
             min(routes['binned']['soft_rasterize_step_ms']))

    import subprocess
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
