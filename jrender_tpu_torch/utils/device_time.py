"""Kernels' own device time, read with torch.profiler (CUPTI): what a kernel
costs on the card without the host work of the wrapper that launches it
(checks, allocations, ctypes lookups), which CUDA events around wrapper
calls also read when it outlasts the kernel.

    from jrender_tpu_torch.utils.device_time import device_ms
    device_ms(step, {'softras_bwd': ('softras_bwd_kernel', 'softras_bwd_big_kernel')})
    # {'softras_bwd': ms}, the median over 20 calls of step

``chip_smoke.py`` and the timing tools read their ``device_ms`` with it;
``device_total`` reads a whole stage (every kernel, copy and fill), and
``events_ms`` the host's view, CUDA events around calls.
It imports nothing of the package, so a tool may load this file alone to
time another checkout with the same timer.  Needs a CUDA card.
"""
from __future__ import annotations

import re


def device_ms(fn, kernels: dict, reps: int = 20, tries: int = 3) -> dict:
    """Per call of ``fn`` (``reps`` calls under a profiler, after as many
    warm-up calls under it), the device time in ms of each entry of
    ``kernels`` (a name -> the kernel functions it launches, matched as
    whole words in the profiler's demangled names): for each function, the
    median duration of its launches times its launches a call, summed over
    the functions.  Only the launches after the warm-up count: the profiler
    can miss the first launches of a trace, so they run untimed.  A trace
    that still saw an entry's kernels fewer than ``reps`` / 2 times is taken
    again, up to ``tries`` traces; then it raises."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    pats = {name: [re.compile(r'\b' + re.escape(f) + r'\b') for f in fns]
            for name, fns in kernels.items()}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
            with record_function('device_ms.timed'):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        evs = prof.events()
        t0 = min(e.time_range.start for e in evs if e.name == 'device_ms.timed')
        ev = [e for e in evs if e.device_type == DeviceType.CUDA and e.time_range.start >= t0]
        out, short = {}, []
        for name, fpats in pats.items():
            total, most = 0.0, 0
            for pat in fpats:
                d = [e.time_range.elapsed_us() / 1e3 for e in ev if pat.search(e.name)]
                if d:
                    total += max(1, round(len(d) / reps)) * float(np.median(d))
                    most = max(most, len(d))
            if most < reps / 2:
                short.append(f'{name}: {most} launches of {kernels[name]} in {reps} calls')
            out[name] = total
        if not short:
            return out
    raise RuntimeError('; '.join(short))


# traces that ``device_total`` takes before it gives up
TOTAL_TRIES = 5
_FENCE = re.compile(r'\bspin_kernel\b')   # torch.cuda._sleep's kernel


def device_total(fn, reps: int = 10, least: int = 0) -> dict:
    """Per call of ``fn`` (``reps`` calls under a profiler, after as many
    warm-up calls under it): 'device_ms', the summed duration of every
    device activity (kernels, copies, fills); 'kernels', the kernels
    launched; 'copies', the copies and fills; 'by_kernel', each kernel
    name's ms.  What a stage of plain torch and kernels costs on the card
    and how many launches it makes.

    The timed calls' activity is what the device ran between two fences,
    ``torch.cuda._sleep`` kernels launched with the card idle before and
    after the calls, so the window is read on the device's clock alone.
    A trace counts when its kernels a call are a whole number of at least
    ``least`` (the launches that the wrappers count in one call); the
    result is the first trace that counts and agrees in its kernels with
    an earlier one that counts.  After ``TOTAL_TRIES`` traces it raises:
    the profiler lost events (it loses fences and kernels in a process that
    ran chip_smoke.py's phases 3-17, so phase 18 runs its stage tool in a
    process of its own).  Needs a CUDA card."""
    import time
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def fence():
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    seen, counted = [], []
    for _ in range(TOTAL_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            fence()
            time.sleep(0.01)
            for _ in range(reps):
                fn()
            fence()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
        fences = sorted((e.time_range for e in dev if _FENCE.search(e.name)),
                        key=lambda r: r.start)
        if len(fences) != 2:
            seen.append(f'{len(fences)} fences')
            continue
        t0, t1 = fences[0].end, fences[1].start
        ev = [e for e in dev if t0 <= e.time_range.start < t1 and not _FENCE.search(e.name)]
        by_kernel = defaultdict(float)
        kernels = copies = 0
        for e in ev:
            if re.search(r'\bMem(cpy|set)\b', e.name):
                copies += 1
            else:
                kernels += 1
                by_kernel[e.name] += e.time_range.elapsed_us() / 1e3 / reps
        seen.append(f'{kernels} kernels')
        if kernels % reps or kernels < least * reps:
            continue
        if kernels in counted:
            return {'device_ms': sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps,
                    'kernels': kernels // reps, 'copies': copies / reps,
                    'by_kernel': dict(by_kernel)}
        counted.append(kernels)
    raise RuntimeError(f'device_total: no two traces of {reps} calls of {fn} agree on a whole '
                       f'number of at least {least} kernels a call: {", ".join(seen)}')


def events_ms(fn, reps: int = 20) -> float:
    """ms per call of ``fn`` by CUDA events around ``reps`` calls, after
    one warm-up call: what the host sees, wrappers' work included."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps
