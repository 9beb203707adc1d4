"""The readers of the program's own spans (``prep_ms``, ``kernel_ms``,
``syncs``, ``sync_wait_ms``) on a Chrome trace built by hand, and their
silence on a program that carries no ``jr.*`` span."""
import copy
import json

import pytest

from benchmark.harness import registry
from benchmark.harness.trace import Trace

from conftest import ROOT

MAIN, AUTOGRAD, STREAM = 10, 20, 7
READERS = ('prep_ms', 'kernel_ms', 'syncs', 'sync_wait_ms')


def _step(t0: float, corr0: int) -> list:
    """One fit step from ``t0`` (us): the render on the stepping thread, the
    rasterizer's backward on the autograd thread, a closing synchronize."""
    ev, corr = [], [corr0]

    def host(name, ts, dur, tid=MAIN, cat='user_annotation'):
        ev.append({'ph': 'X', 'cat': cat, 'name': name, 'pid': 1, 'tid': tid,
                   'ts': t0 + ts, 'dur': dur})

    def launch(ts, device_us, tid=MAIN):
        corr[0] += 1
        ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'pid': 1,
                   'tid': tid, 'ts': t0 + ts, 'dur': 1, 'args': {'correlation': corr[0]}})
        ev.append({'ph': 'X', 'cat': 'kernel', 'name': f'k{corr[0]}', 'pid': 0, 'tid': STREAM,
                   'ts': t0 + ts + 2, 'dur': device_us, 'args': {'correlation': corr[0]}})

    host('bench.step', 0, 100)
    host('jr.render_mesh', 5, 45)
    host('jr.lighting', 6, 4)
    launch(7, 2)
    host('cudaMemcpy', 8, 1, cat='cuda_runtime')              # counted: 1 us
    host('cudaMemcpyAsync', 9, 0.5, cat='cuda_runtime')       # not a wait
    host('jr.transform', 11, 4)
    launch(12, 1)
    host('jr.raster', 16, 33)
    host('jr.raster.prep', 17, 13)
    launch(18, 3)                                             # prep: 3 us
    host('cudaStreamSynchronize', 20, 4, cat='cuda_runtime')  # counted: 4 us
    host('jr.binning', 21, 8)
    launch(22, 5)                                             # prep: 5 us
    host('jr.kernel.softras_fwd', 31, 2)
    launch(32, 10)                                            # kernel: 10 us
    launch(40, 1)                                             # the rasterizer's glue
    launch(55, 1)                                             # the loss
    host('jr.raster.backward', 60, 20, tid=AUTOGRAD)
    host('jr.kernel.softras_bwd', 61, 2, tid=AUTOGRAD)
    launch(62, 8, tid=AUTOGRAD)                               # kernel: 8 us
    host('cudaStreamSynchronize', 70, 2, tid=AUTOGRAD, cat='cuda_runtime')   # counted: 2 us
    host('cudaDeviceSynchronize', 90, 5, cat='cuda_runtime')  # the closing one
    return ev


def _events() -> list:
    ev = []
    # before the window: a render and its synchronize, not counted
    ev.append({'ph': 'X', 'cat': 'user_annotation', 'name': 'jr.render_mesh', 'pid': 1,
               'tid': MAIN, 'ts': 40, 'dur': 20})
    ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaStreamSynchronize', 'pid': 1,
               'tid': MAIN, 'ts': 50, 'dur': 3})
    ev += _step(100, 0) + _step(300, 100)
    # between the steps, on the autograd thread: not counted
    ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaStreamSynchronize', 'pid': 1,
               'tid': AUTOGRAD, 'ts': 250, 'dur': 7})
    return ev


def _trace(tmp_path, events) -> Trace:
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    return Trace(str(path))


def _read(name, tr):
    return registry.metric_reader(ROOT / 'benchmark', f'{name}.fit')({'trace': tr, 'steps': 2})


@pytest.mark.parametrize('name,want', [
    ('prep_ms', 0.008),          # 3 + 5 us a step
    ('kernel_ms', 0.018),        # 10 + 8 us
    ('syncs', 3.0),              # the memcpy, the prep's and the autograd thread's syncs
    ('sync_wait_ms', 0.007),     # 1 + 4 + 2 us
])
def test_reader_reads_the_program_spans(name, want, tmp_path):
    assert _read(name, _trace(tmp_path, _events())) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('name', READERS)
def test_reader_is_silent_without_program_spans(name, tmp_path):
    events = [e for e in copy.deepcopy(_events()) if not e['name'].startswith('jr.')]
    assert _read(name, _trace(tmp_path, events)) is None


def test_each_reader_has_both_entries():
    bench = registry.load_benchmark(ROOT)
    entries = {m['name']: m for m in bench['per_layer']}
    for name in READERS:
        fit, render = entries[f'{name}.fit'], entries[f'{name}.render']
        assert (fit['moves'], render['moves']) == ('step_ms', 'frames_per_s')
        assert all(w.endswith('.fit8') for w in fit['workloads'])
        assert all('.frames' in w for w in render['workloads'])
        assert fit['source'] == render['source'] == 'device_trace'
