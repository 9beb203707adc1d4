"""Kernels' own device time, read with torch.profiler (CUPTI): what a kernel
costs on the card without the host work of the wrapper that launches it
(checks, allocations, ctypes lookups), which CUDA events around wrapper
calls also read when it outlasts the kernel.

    from jrender_tpu_torch.utils.device_time import device_ms
    device_ms(step, {'softras_bwd': ('softras_bwd_kernel', 'softras_bwd_big_kernel')})
    # {'softras_bwd': ms}, the median over 20 calls of step

``chip_smoke.py`` and the timing tools read their ``device_ms`` with it.
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
