"""The check that decides ``correct``: a sound run passes it, the control
(the reference in bfloat16 in the program's place) fails the cell's
limits, and so does a run with each fault the cell can have planted under
the timed path (the kind's ``FAULTS``).  Each run here is ``run_cell`` on
the CPU, everything but the look for a card, at a size the CPU holds.
Also: ``run.py`` with no card, and a short run on the card where there is
one."""
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import check, runner

from conftest import ROOT, small_cell

CELLS = ['softras_sphere39k_1024.fit8', 'n3mr_sphere39k_1024.fit8',
         'softras_sphere39k_1024.frames8', 'n3mr_sphere39k_1024.frames32']
SEED = 2 ** 31 + 977


def _run(name, fault=None, tmp='.'):
    """A run of the cell, with the kind's fault ``fault`` planted."""
    cell = small_cell(name)
    if fault is None:
        return runner.run_cell(cell, SEED, 0.3, False, 'cpu', time.perf_counter(), tmp)
    plant = cell.kind_module().FAULTS[fault]
    with plant(cell.program_module().program(cell.config, 'cpu')) as broken:
        return runner.run_cell(cell, SEED, 0.3, False, 'cpu', time.perf_counter(), tmp,
                               build_program=lambda cfg, device: broken)


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name, torch_threads, tmp_path):
    r = _run(name, tmp=str(tmp_path))
    assert r['correct'], r['checks']
    assert list(r)[-1] == 'checks' and r['attempted'] >= 1


@pytest.mark.parametrize('name', CELLS)
def test_control_fails(name, torch_threads):
    """The reference computed in bfloat16, in the program's place."""
    cell = small_cell(name)
    cfg, mix, ref = cell.config, cell.traffic, cell.reference_module()
    kind = cell.kind_module()
    inp = kind.make_inputs(cfg, mix, SEED, 'cpu')
    if mix['kind'] == 'fit':
        numbers = kind.compare(kind.reference(ref, cfg, inp, mix, torch.bfloat16),
                               kind.reference(ref, cfg, inp, mix))
    else:
        numbers = kind.compare(kind.reference(ref, cfg, inp, 3, torch.bfloat16),
                               kind.reference(ref, cfg, inp, 3))
    correct, checks = check.judge(numbers, check.load_limits(cell.bench_dir, name))
    assert not correct, checks


@pytest.mark.parametrize('fault', ['half', 'altered'])
@pytest.mark.parametrize('name', CELLS)
def test_planted_fault_fails(name, fault, torch_threads, tmp_path):
    r = _run(name, fault, str(tmp_path))
    assert not r['correct'], r['checks']


@pytest.mark.parametrize('name', CELLS[:2])
def test_vertex_gradient_fault_fails(name, torch_threads, tmp_path):
    """The offsets' gradient halved, the forward untouched: ``grad`` sees
    it although the textures' leaf is the larger."""
    r = _run(name, 'vertex_grad', str(tmp_path))
    assert r['checks']['image']['value'] == 0.0
    assert not r['correct'], r['checks']


@pytest.mark.parametrize('name', CELLS[:2])
def test_unchanged_state_fails(name, torch_threads, tmp_path):
    r = _run(name, 'unchanged', str(tmp_path))
    assert r['checks']['change']['value'] == pytest.approx(1.0)
    assert not r['correct']


def test_run_without_a_card_fails(no_card):
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
                        '--seed', '1', '--seconds', '1', '--trace', '0'],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'no CUDA device' in p.stderr


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[2],
                        '--seed', str(SEED), '--seconds', '2', '--trace', '0'],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r['correct'] and r['device']['platform'] == 'gpu'
    assert set(r['metrics']) == {'frames_per_s', 'frame_p95_ms', 'peak_mem_gib', 'setup_s'}
