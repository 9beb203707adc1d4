"""The port's own spans (``jrender_tpu_torch.utils.profiling.annotate``):
gated off when no profiler runs, nested as the render path nests, and, on
the card, around every hand-kernel launch.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; its one test for the card skips without one.
On a machine with a card, run it without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jrender_tpu_torch as jt
from jrender_tpu_torch.ops.softras import binning
from jrender_tpu_torch.utils import profiling
from jrender_tpu_torch.utils.primitives import uv_sphere

DR_TYPES = ('softras', 'n3mr')
STAGES = ('jr.lighting', 'jr.transform', 'jr.raster')
# the hand kernels of csrc/ by the profiler's demangled names: their
# namespaces and function names (PyTorch's own kernels hold none of these)
HAND_KERNEL = re.compile(r'softras|n3mr|segsum|segment_sum')


def fit_step(dr_type: str, device, image_size: int = 32, rings: int = 9, segs: int = 10):
    """render_mesh of a UV sphere, a loss on every output, and its backward
    into the vertices and the textures."""
    v, f = uv_sphere(rings, segs)
    rng = np.random.RandomState(0)
    shape = (1, f.shape[0], 4, 3) if dr_type == 'softras' else (1, f.shape[0], 2, 2, 2, 3)
    vt = torch.tensor(v[None], device=device, requires_grad=True)
    tex = torch.tensor(rng.uniform(size=shape).astype(np.float32), device=device,
                       requires_grad=True)
    mesh = jt.Mesh(vt, torch.tensor(f[None], device=device), textures=tex,
                   texture_type='surface', dr_type=dr_type, device=device)
    r = jt.Renderer(image_size=image_size, dr_type=dr_type, sigma_val=1e-4, device=device)
    r.transform.set_eyes_from_angles(2.732, 20, 60)
    out = r.render_mesh(mesh, mode=None)
    sum(o.sum() for o in out).backward()
    assert vt.grad is not None and tex.grad is not None


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize('dr_type', DR_TYPES)
def test_annotate_enters_no_record_function_without_a_profiler(dr_type, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler running')

    monkeypatch.setattr(torch.ops.profiler, '_record_function_enter_new', refuse)
    with pytest.raises(AssertionError, match='no profiler'):
        with torch.profiler.record_function('bites'):
            pass
    fit_step(dr_type, 'cpu')
    with profiling.annotate('jr.test'):
        pass
    face = torch.tensor(np.random.RandomState(1).uniform(-1, 1, (1, 40, 9)).astype(np.float32))
    binning.build_tile_lists_compact(face, 32, 16, 16, 1e-4)


@pytest.mark.parametrize('dr_type', DR_TYPES)
def test_render_path_spans_nest(dr_type):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit_step(dr_type, 'cpu')
    events = prof.events()
    by = {name: [e for e in events if e.name == name]
          for name in ('jr.render_mesh', 'jr.raster.backward') + STAGES}
    assert len(by['jr.render_mesh']) == 1 and len(by['jr.raster.backward']) == 1
    top = by['jr.render_mesh'][0]
    for name in STAGES:
        assert len(by[name]) == 1 and _inside(by[name][0], top), name
    assert not _inside(by['jr.raster.backward'][0], top)


def test_binning_span():
    face = torch.tensor(np.random.RandomState(2).uniform(-1, 1, (2, 60, 9)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        binning.build_tile_lists_compact(face, 64, 16, 16, 1e-4, with_inverse=True)
    assert [e.name for e in prof.events()].count('jr.binning') == 1


@pytest.mark.gpu
@pytest.mark.parametrize('dr_type', DR_TYPES)
def test_every_hand_kernel_launch_is_in_a_kernel_span(dr_type, tmp_path):
    """A fit step on the card at 128 px: each launch of a hand kernel lies
    inside a ``jr.kernel.*`` range of its own thread, and the backward's
    span is recorded on the autograd engine's thread."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    fit_step(dr_type, 'cuda', 128, 20, 24)          # the kernels built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_step(dr_type, 'cuda', 128, 20, 24)
        torch.cuda.synchronize()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())['traceEvents'] if e.get('ph') == 'X']
    launches = {e['args']['correlation']: e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in e.get('args', {})}
    spans = [e for e in events if e.get('cat') == 'user_annotation']
    kernels = [e for e in events if e.get('cat') == 'kernel' and HAND_KERNEL.search(e['name'])]
    assert kernels, 'no hand kernel in the trace'
    for k in kernels:
        launch = launches[k['args']['correlation']]
        assert any(s['name'].startswith('jr.kernel.') and s['tid'] == launch['tid']
                   and s['ts'] <= launch['ts'] <= s['ts'] + s['dur'] for s in spans), k['name']
    top = [s for s in spans if s['name'] == 'jr.render_mesh']
    back = [s for s in spans if s['name'] == 'jr.raster.backward']
    assert len(top) == 1 and len(back) == 1 and back[0]['tid'] != top[0]['tid']


SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize', 'cudaMemcpy')


@pytest.mark.gpu
@pytest.mark.parametrize('dr_type', DR_TYPES)
def test_render_path_waits_for_the_card_nowhere(dr_type, tmp_path):
    """After one call (the kernels built, the constants on the card), a
    fit step at 128 px makes no call that waits for the card inside a
    ``jr.*`` range of its own thread: no stream or device synchronise, no
    synchronous copy."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    fit_step(dr_type, 'cuda', 128, 20, 24)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_step(dr_type, 'cuda', 128, 20, 24)
        torch.cuda.synchronize()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())['traceEvents'] if e.get('ph') == 'X']
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e['name'].startswith('jr.')]
    assert any(s['name'] == 'jr.render_mesh' for s in spans)
    assert not any(s['name'] == 'jr.const.upload' for s in spans)
    waits = [(e['name'], s['name']) for e in events
             if e.get('cat') == 'cuda_runtime' and e['name'] in SYNC_CALLS
             for s in spans if s['tid'] == e['tid'] and s['ts'] <= e['ts'] <= s['ts'] + s['dur']]
    assert not waits, waits
