"""Profiling helpers on torch.profiler (counterpart of
``jrender_tpu/utils/profiling.py``):

    with profiling.trace('/tmp/trace'):        # a Chrome trace into the dir
        step(...)

    with profiling.annotate('rasterize'):      # a named span in the trace
        out = soft_rasterize(...)

An operator traces their own calls with ``trace``: the Chrome trace holds
the program's ``jr.*`` spans beside the card's kernels, copies and fills,
on one clock, each span nested in the one that called it:

  ``jr.render_mesh``        ``Renderer.render_mesh``, the whole call
  ``jr.lighting``, ``jr.transform``, ``jr.raster``
                            its three stages
  ``jr.raster.backward``    the rasterizer's backward (SoftRas, N3MR), on
                            the autograd engine's thread
  ``jr.raster.prep``        the rasterizer's prep: SoftRas's rows and tile
                            lists (each route's table), N3MR's fill_back,
                            rows and tile lists
  ``jr.binning``            the tile lists (``binning.build_tile_lists_compact``)
  ``jr.n3mr.edge.inputs``, ``jr.n3mr.edge.sort``
                            N3MR's edge-gradient inputs and its sort of the
                            band keys
  ``jr.kernel.<entry>``     every hand-kernel launch (``cuda_impl._run``),
                            named by its entry point: ``jr.kernel.softras_fwd``,
                            ``jr.kernel.n3mr_edgebwd``, ``jr.kernel.segment_sum``...

``annotate`` enters ``torch.profiler.record_function`` only while a
profiler is collecting; otherwise it returns one shared no-op context, so
a span costs one flag test when nothing traces (``record_function``
itself costs a dispatcher call even then).

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
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


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
    """Named region: a span in profiler traces while a profiler collects
    (on any thread it reaches: the autograd engine's too), else a no-op."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
