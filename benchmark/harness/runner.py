"""One run of one cell: set-up, the window (or the traced window), the
check, the result.  What differs between traffic kinds (the inputs, the
call, set-up, the window, the traced call and what its readers read, the
check's numbers) is the kind module's; what is here every kind shares.

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

from benchmark.harness import check, guard, traffic
from benchmark.harness.trace import Trace

GIB = 2 ** 30


def _cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if _cuda(device) else 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             tmp: str, build_program=None) -> dict:
    """The result of one run of ``cell`` (a ``registry.Cell``), driven by
    the module of its traffic's kind (``kinds/<kind>.py``).
    ``build_program(cfg, device)``, where given, makes the system under
    test in place of the configuration's (a test's broken program)."""
    cfg, mix = cell.config, cell.traffic
    kind = cell.kind_module()
    make = build_program or cell.program_module().program
    ref = cell.reference_module()
    marks = [('start', t_start)]
    prog = make(cfg, device)
    marks.append(('program', time.perf_counter()))
    inp = kind.make_inputs(cfg, mix, seed, device)
    traffic.sync(device)
    marks.append(('inputs', time.perf_counter()))
    if trace:
        prog.add_spans()
    call = kind.Call(prog, inp, mix)
    note = kind.setup(call, mix)
    traffic.sync(device)
    marks.append(('warm-up', time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print('set-up s: ' + ', '.join(f'{a} {t - marks[i][1]:.3f}' for i, (a, t)
                                  in enumerate(marks[1:])) + note, file=sys.stderr)
    bad = guard.forbidden_modules()
    if bad:
        raise RuntimeError(f'modules of JAX or the JAX package loaded at set-up: {bad}')
    setup_peak = _peak(device)
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats()

    rng = random.Random(seed)
    metrics, dev_extra, breakdown = {}, {}, None
    if not trace:
        attempted, metrics = kind.window(call, seconds, rng.getrandbits(63))
        metrics['peak_mem_gib'] = _peak(device) / GIB
        metrics['setup_s'] = setup_s
        kept = call.kept
    else:
        host = traffic.host_times(call.enqueue, mix[kind.HOST_COUNT], device)
        n = mix[kind.TRACED_COUNT]
        traced = kind.traced_call(call, n, rng.getrandbits(63))
        first = traced.k + 2
        path = os.path.join(tmp, f'bench_trace_{os.getpid()}.json')
        try:
            traffic.traced(traced, n, path)
            print(f'trace bytes: {os.path.getsize(path)}', file=sys.stderr)
            tr = Trace(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        kept = traced.kept
        attempted = n
        ctx = kind.layer_context(cell, prog, ref, inp, traced, tr, host, n, first)
        for m in cell.per_layer:
            v = cell.metric_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = v
        dev_extra = {'busy_s': tr.busy_s, 'window_s': tr.window_s}
        breakdown = {'device_ops': tr.top_device_ops(), 'idle_gaps': tr.idle_gaps()}
        del traced
    peak = max(setup_peak, _peak(device))

    # the check: after the window, with the program's state freed
    del call, prog
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = kind.numbers(cfg, mix, ref, inp, kept)
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
