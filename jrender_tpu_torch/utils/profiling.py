"""Profiling helpers on torch.profiler (counterpart of
``jrender_tpu/utils/profiling.py``):

    with profiling.trace('/tmp/trace'):        # a Chrome trace into the dir
        step(...)

    with profiling.annotate('rasterize'):      # a named span in the trace
        out = soft_rasterize(...)

    with profiling.timed('rasterize') as t:    # wall clock, the card synchronised
        out = soft_rasterize(...)
    print(t.ms)

The NeRF trainer's ``--profile_dir`` traces one dispatch of steps with
``trace``.  Unlike the JAX package's, ``trace`` swallows no exception:
torch.profiler is always there, and a silent no-op would hide a broken
trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _card_in_use(device=None) -> bool:
    if device is not None:
        return torch.device(device).type == 'cuda'
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block (CPU, and CUDA where the card is in use: ``device``
    is a CUDA device, or None and CUDA is initialised) and write its Chrome
    trace, ``trace_<pid>_<ns>.json``, into ``log_dir``; yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = _card_in_use(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


def annotate(name: str):
    """Named region: a span in profiler traces."""
    return torch.profiler.record_function(name)


class _Timer:
    __slots__ = ('ms',)

    def __init__(self):
        self.ms = 0.0


def _sync():
    if _card_in_use():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str | None = None, sync: bool = True):
    """Wall-clock a block; with ``sync`` the card (when in use) finishes its
    queued work before and after, so asynchronous launches are not
    misattributed."""
    if sync:
        _sync()
    t = _Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if sync:
            _sync()
        t.ms = (time.perf_counter() - t0) * 1e3
        if name:
            print(f'[timed] {name}: {t.ms:.3f} ms')
