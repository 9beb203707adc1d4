"""The harness's readings at CPU size against those it gave before each
traffic kind became a file of its own (``kinds/<kind>.py``).

``pinned_readings.json`` was written by the harness as it stood before
that move, through its own API then, for each cell at
``conftest.small_cell``'s size (64 px, 308 faces, 2 views) and two seeds,
with 4 threads.  It holds only what the harness and the references own,
never a number that the program's arithmetic makes: the digest of every
tensor ``make_inputs`` made; the control's check numbers (the reference in
bfloat16 against itself in float32, with each leaf's norms); and a traced
run's census counts and least times, as the layer context handed them to
the per-layer readers, the profiler and its trace replaced by stand-ins
and a fit cell's optimizer frozen (the kind's ``unchanged``), so that the
census counts the harness's own start.  All of it must be bit-equal: two
runs of the pinning harness agreed to the last bit, so the gap a float may
show (``GAP``) is 0.  The program's numbers are held to the cell's limits
instead: a sound program within them, each fault outside.  ATen's CPU
capability (``ATEN_CPU_CAPABILITY``) picks the readings: AVX512 and AVX2
gave the same (``vector``); DEFAULT, with no vector kernels, rounds some
results otherwise (``scalar``, from one run).
"""
import contextlib
import hashlib
import json
import time
from pathlib import Path

import pytest
import torch

import benchmark.calibrate as calibrate
from benchmark.harness import check, mesh, runner, traffic

from conftest import small_cell

PINNED = json.loads((Path(__file__).parent / 'pinned_readings.json').read_text())
CASES = sorted(PINNED['cells'])          # '<cell>/<seed>'
GAP = 0.0                                # two runs of the pinning harness agreed exactly
H100 = 'NVIDIA H100 80GB HBM3'           # the card whose peaks the least times take


@pytest.fixture
def pinned(case):
    """(cell, seed, its pinned readings) on the pinning's thread count."""
    cap = torch.backends.cpu.get_cpu_capability()
    assert cap in PINNED['capabilities'], f'no readings pinned for the CPU capability {cap}'
    readings = PINNED['cells'][case][PINNED['capabilities'][cap]]
    n = torch.get_num_threads()
    torch.set_num_threads(PINNED['threads'])
    name, seed = case.split('/')
    yield small_cell(name), int(seed), readings
    torch.set_num_threads(n)


def _digest(t):
    t = t.detach().contiguous().cpu()
    return {'sha256': hashlib.sha256(t.numpy().tobytes()).hexdigest(),
            'dtype': str(t.dtype), 'shape': list(t.shape)}


def _same(got, want, path=''):
    """``got`` equals ``want``; a float within ``GAP``."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f'{path}[{i}]')
    elif isinstance(want, float):
        assert abs(got - want) <= GAP, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize('case', CASES)
def test_inputs_are_pinned(pinned):
    cell, seed, want = pinned
    inp = cell.kind_module().make_inputs(cell.config, cell.traffic, seed, 'cpu')
    got = {k: _digest(getattr(inp, k)) for k in ('template', 'faces', 'textures', 'raw', 'eyes')}
    got.update({f'targets.{k}': _digest(v) for k, v in inp.targets.items()})
    got.update(offset_scale=inp.offset_scale, views=inp.views)
    _same(got, want['inputs'])


@pytest.mark.parametrize('case', CASES)
def test_control_numbers_are_pinned(pinned, monkeypatch):
    cell, seed, want = pinned
    monkeypatch.setattr(calibrate, 'DEVICE', 'cpu')
    _same(calibrate.control_numbers(cell, cell.kind_module(), seed), want['control'])


@pytest.mark.parametrize('case', CASES)
def test_calibrate_numbers_hold_their_limits(pinned, monkeypatch):
    """``calibrate.py``'s numbers of the program are within the cell's
    limits, and those of each of the kind's faults are not."""
    cell, seed, _ = pinned
    monkeypatch.setattr(calibrate, 'DEVICE', 'cpu')
    kind = cell.kind_module()
    limits = check.load_limits(cell.bench_dir, cell.name)
    prog = cell.program_module().program(cell.config, 'cpu')

    def judged(p):
        numbers = calibrate.program_numbers(cell, kind, p, seed)
        numbers.pop('leaves', None)
        return check.judge(numbers, limits)
    correct, checks = judged(prog)
    assert correct, checks
    for name in kind.FAULTS:
        with kind.FAULTS[name](prog) as broken:
            correct, checks = judged(broken)
        assert not correct, (name, checks)


class _Trace:
    """A stand-in for ``harness.trace.Trace``: no spans, fixed busy and window
    times."""
    busy_s, window_s, activities, t0 = 1.0, 2.0, 10, 0.0
    host, steps = [], []

    def __init__(self, path):
        pass

    def span_device_s(self, pattern):
        return 0.0, 0

    def top_device_ops(self, n=10):
        return []

    def idle_gaps(self, n=10):
        return []


def _traced(call, n, path):
    for _ in range(n + 2):
        call()
    Path(path).write_text('{}')


@pytest.mark.parametrize('case', CASES)
def test_traced_run_is_pinned(pinned, monkeypatch, tmp_path):
    cell, seed, want = pinned
    seen = {}
    context = mesh.layer_context

    def layer_context(*a, **k):
        seen.update(context(*a, **k))
        return seen
    monkeypatch.setattr(traffic, 'traced', _traced)
    monkeypatch.setattr(runner, 'Trace', _Trace)
    monkeypatch.setattr(mesh, 'layer_context', layer_context)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda *a: H100)
    prog = cell.program_module().program(cell.config, 'cpu')
    freeze = cell.kind_module().FAULTS.get('unchanged', contextlib.nullcontext)
    with freeze(prog) as frozen:
        r = runner.run_cell(cell, seed, 0.3, True, 'cpu', time.perf_counter(), str(tmp_path),
                            build_program=lambda cfg, device: frozen)
    got = {k: seen[k] for k in ('counts', 'least_raster_s', 'least_step_s', 'steps')}
    got.update(attempted=r['attempted'], correct=r['correct'])
    _same(got, want['traced'])
