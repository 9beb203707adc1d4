"""One run of one cell: set-up, the window (or the traced window), the
check, the result.

``run_cell`` is what ``run.py`` calls on the card; the harness's CPU tests
call it with ``device='cpu'`` on small sizes, where the program runs its
plain PyTorch versions and nothing is timed that matters.
"""
from __future__ import annotations

import gc
import os
import random
import sys
import time

import torch

from benchmark.harness import check, guard, peaks, traffic
from benchmark.harness.trace import Trace

GIB = 2 ** 30


def _cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if _cuda(device) else 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             tmp: str, build_program=None) -> dict:
    """The result of one run of ``cell`` (a ``registry.Cell``).
    ``build_program(cfg, device)``, where given, makes the system under
    test in place of the configuration's (a test's broken program)."""
    cfg, mix = cell.config, cell.traffic
    kind = mix['kind']
    make = build_program or cell.program_module().program
    ref = cell.reference_module()
    marks = [('start', t_start)]
    prog = make(cfg, device)
    marks.append(('program', time.perf_counter()))
    inp = traffic.make_inputs(cfg, mix, seed, device)
    traffic.sync(device)
    marks.append(('inputs', time.perf_counter()))
    if trace:
        prog.add_spans()
    record = None
    if kind == 'fit':
        call = traffic.FitStep(prog, inp, mix)
        record = traffic.fit_setup(call, mix)
    else:
        call = traffic.Frames(prog, inp)
        for _ in range(mix['warmup_requests']):
            call()
    traffic.sync(device)
    marks.append(('warm-up', time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print('set-up s: ' + ', '.join(f'{a} {t - marks[i][1]:.3f}' for i, (a, t)
                                  in enumerate(marks[1:]))
          + ('' if record is None else f' (steps {", ".join(f"{t:.3f}" for t in record["step_s"])})'),
          file=sys.stderr)
    bad = guard.forbidden_modules()
    if bad:
        raise RuntimeError(f'modules of JAX or the JAX package loaded at set-up: {bad}')
    setup_peak = _peak(device)
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats()

    rng = random.Random(seed)
    metrics, dev_extra, breakdown, kept = {}, {}, None, None
    if not trace:
        if kind == 'fit':
            w = traffic.fit_window(call, seconds)
            attempted = w['steps']
            metrics['step_ms'] = w['step_ms']
        else:
            w = traffic.frames_window(call, seconds, rng.getrandbits(63))
            attempted = w['requests']
            kept = w['kept']
            metrics['frames_per_s'] = w['frames_per_s']
            metrics['frame_p95_ms'] = w['p95_ms']
        metrics['peak_mem_gib'] = _peak(device) / GIB
        metrics['setup_s'] = setup_s
    else:
        n_host = mix['host_steps' if kind == 'fit' else 'host_requests']
        host = traffic.host_times(call if kind == 'fit' else call.enqueue, n_host, device)
        n = mix['traced_steps' if kind == 'fit' else 'traced_requests']
        if kind == 'fit':
            geometry = (inp.vertices(call.raw.detach()), call.textures.detach())
        else:
            geometry = (inp.template, inp.textures)
            call = Keeper(call, n, rng.getrandbits(63))
        first = call.k + 2
        path = os.path.join(tmp, f'bench_trace_{os.getpid()}.json')
        try:
            traffic.traced(call, n, path)
            print(f'trace bytes: {os.path.getsize(path)}', file=sys.stderr)
            tr = Trace(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        if kind != 'fit':
            kept = call.kept
        attempted = n
        ctx = layer_context(cell, prog, ref, inp, tr, host, n, first, geometry, kind)
        for m in cell.per_layer:
            v = cell.metric_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = v
        dev_extra = {'busy_s': tr.busy_s, 'window_s': tr.window_s}
        breakdown = {'device_ops': tr.top_device_ops(), 'idle_gaps': tr.idle_gaps()}
    peak = max(setup_peak, _peak(device))

    # the check: after the window, with the program's state freed
    del call, prog
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if kind == 'fit':
        numbers = check.fit_numbers(record, check.reference_fit(ref, cfg, inp, mix))
    else:
        k, out = kept
        numbers = check.frames_numbers(out, check.reference_frames(ref, cfg, inp, k))
    traffic.sync(device)
    print(f'check s: {time.perf_counter() - t_ref:.3f}', file=sys.stderr)
    correct, checks = check.judge(numbers, check.load_limits(cell.bench_dir, cell.name))

    units = {m['name']: m['unit'] for m in cell.end_to_end + cell.per_layer}
    result = {
        'correct': correct,
        'attempted': attempted,
        'failed': 0,
        'metrics': {k: {'value': v, 'unit': units[k]} for k, v in metrics.items()},
        'device': {
            'platform': 'gpu' if _cuda(device) else 'cpu',
            'kind': torch.cuda.get_device_name(0) if _cuda(device) else 'cpu',
            'count': cell.entry['chips'],
            'memory_peak_bytes': peak,
            **dev_extra,
        },
    }
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    return result


class Keeper:
    """A frames call that keeps one request's outputs of the traced window,
    drawn from the seed by reservoir sampling (the two calls before the
    window's ranges are not drawn from)."""

    def __init__(self, frames, n: int, seed: int):
        self.frames, self.rng, self.seen, self.kept = frames, random.Random(seed), -2, None

    @property
    def k(self):
        return self.frames.k

    def __call__(self):
        k = self.frames.k
        out = self.frames()
        self.seen += 1
        if self.seen >= 1 and self.rng.random() * self.seen < 1.0:
            self.kept = (k, out)
        return out


def layer_context(cell, prog, ref, inp, tr: Trace, host: list, n: int, first: int,
                  geometry, kind: str) -> dict:
    """What the per-layer readers read: the trace's spans and activity, the
    host times, and the least time of the rasterizer and of the step on the
    traced window's inputs (counted by the reference from its geometry)."""
    cfg = cell.config
    vertices, textures = geometry
    eyes = inp.eyes[first % traffic.TABLE]
    counts = ref.census(cfg, inp.batch(vertices), inp.batch(inp.faces), inp.batch(textures), eyes)
    fit = kind == 'fit'
    ops, nbytes = ref.least_work(cfg, counts, inp.views, fit)
    kind_name = torch.cuda.get_device_name(0)
    N, V, HW = inp.views, vertices.shape[1], cfg['image_size'] ** 2
    tex = textures[0].numel()
    other = 4 * ((N + 1) * tex + (N + 1) * V * 3)           # lighting, transform
    if fit:
        other += 4 * (3 * N * 4 * HW + 7 * (V * 3 + tex))   # loss, Adam
    lighting, _ = tr.span_device_s('renderer\\.lighting')
    transform, _ = tr.span_device_s('renderer\\.transform')
    raster, _ = tr.span_device_s('raster\\.forward')
    if fit and prog.backward_op:
        raster += tr.span_device_s(prog.backward_op)[0]
    return {
        'steps': n, 'host_s': host, 'window_s': tr.window_s,
        'busy_s': tr.busy_s, 'activities': tr.activities,
        'lighting_s': lighting, 'transform_s': transform, 'raster_s': raster,
        'least_raster_s': peaks.least_seconds(ops, nbytes, kind_name),
        'least_step_s': peaks.least_seconds(ops, nbytes + other, kind_name),
        'counts': counts, 'trace': tr,
    }
