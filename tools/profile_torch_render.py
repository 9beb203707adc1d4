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
    one block is the critical path of the full frame.

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
    import subprocess
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
