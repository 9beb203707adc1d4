"""The loops that every traffic kind shares: waiting for the card, the
host's time of single calls, and the profiled window.

A mix is a data file, ``traffic/<name>.json``, whose ``kind`` names the
module that drives it, ``kinds/<kind>.py`` (``harness/registry.py``): its
inputs from the seed, its call, its set-up, its window and its check.
"""
from __future__ import annotations

import time

import torch


def sync(device):
    """Wait for the card (nothing to wait for on the CPU, where the
    harness's tests drive the loops)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def host_times(call, n: int, device) -> list:
    """Host seconds of ``n`` calls, each started on an idle card and timed
    to its return; ``call`` is a kind's ``enqueue`` (a fit step, or a
    request without its closing synchronize), which ends in no synchronise
    of the harness's (the program's own host reads inside it stay)."""
    out = []
    for _ in range(n):
        sync(device)
        t = time.perf_counter()
        call()
        out.append(time.perf_counter() - t)
    sync(device)
    return out


def traced(call, n: int, path: str):
    """``n`` calls under torch.profiler, each in a ``bench.step`` range,
    after two calls that the profiler may see only in part; the trace is
    written to ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        for _ in range(n):
            with record_function('bench.step'):
                call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
