"""Every name in BENCHMARK.json resolves to its files, and a configuration,
a traffic mix, a cell and a metric are added by new files and entries
alone; so is a traffic kind, with a configuration that is not a mesh."""
import json
import shutil
import time

import pytest

from benchmark.harness import registry, runner

from conftest import ROOT

NERF = ROOT / 'benchmark' / 'tests' / 'nerf_addition'


# what runner.py and calibrate.py ask of a traffic kind (README, "A traffic kind")
KIND_API = ('make_inputs', 'Call', 'setup', 'window', 'HOST_COUNT', 'TRACED_COUNT',
            'traced_call', 'layer_context', 'numbers', 'control_numbers', 'sample',
            'FAULTS', 'REFERENCE')


def _every_name_resolves(root):
    """Each cell's kind gives the contract's names and finds its counts in
    the mix; its program, the reference functions the kind asks for, its
    limits and its metrics' readers are there."""
    bench = registry.load_benchmark(root)
    for w in bench['workloads']:
        cell = registry.Cell(bench, w['name'], root)
        kind = cell.kind_module()
        assert all(hasattr(kind, a) for a in KIND_API), [a for a in KIND_API
                                                         if not hasattr(kind, a)]
        assert kind.HOST_COUNT in cell.traffic and kind.TRACED_COUNT in cell.traffic
        assert kind.FAULTS and all(callable(f) for f in kind.FAULTS.values())
        assert hasattr(cell.program_module(), 'program')
        ref = cell.reference_module()
        assert all(callable(getattr(ref, f, None)) for f in kind.REFERENCE), kind.REFERENCE
        assert (root / 'benchmark' / 'limits' / f'{w["name"]}.json').is_file()
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m['name']))
    for c in bench['configs']:
        cfg = json.loads((root / c['file']).read_text())
        assert cfg['name'] == c['name']


def test_every_name_resolves():
    _every_name_resolves(ROOT)


def test_each_cell_reports_setup_and_its_metrics():
    bench = registry.load_benchmark(ROOT)
    for w in bench['workloads']:
        cell = registry.Cell(bench, w['name'], ROOT)
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        moved = {m['moves'] for m in cell.per_layer}
        assert moved <= names


def _tree(path):
    return {p.relative_to(path): p.read_bytes() for p in path.rglob('*')
            if p.is_file() and '__pycache__' not in p.parts}


def _checkout(tmp_path):
    """A copy of the benchmark and BENCHMARK.json, and its files' bytes."""
    root = tmp_path / 'checkout'
    shutil.copytree(ROOT / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    return root, _tree(root / 'benchmark')


def test_additions_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell and a metric
    as new files and entries, and find each by its name; no file that was
    there changes."""
    root, before = _checkout(tmp_path)
    b = root / 'benchmark'
    cfg = json.loads((b / 'configs' / 'softras_sphere39k_1024.json').read_text())
    cfg.update(name='softras_sphere3k_1024')
    cfg['mesh']['uv_sphere'].update(rings=38, segs=45)
    (b / 'configs' / 'softras_sphere3k_1024.json').write_text(json.dumps(cfg))
    (b / 'configs' / 'softras_sphere3k_1024.py').write_text(
        (b / 'configs' / 'softras_sphere39k_1024.py').read_text())
    (b / 'reference' / 'softras_sphere3k_1024.py').write_text(
        (b / 'reference' / 'softras_sphere39k_1024.py').read_text())
    (b / 'traffic' / 'frames1.json').write_text(json.dumps(
        dict(json.loads((b / 'traffic' / 'frames8.json').read_text()), views=1)))
    (b / 'metrics' / 'binning_ms.py').write_text('def read(ctx):\n    return None\n')
    (b / 'limits' / 'softras_sphere3k_1024.frames1.json').write_text('{"image": 1e-05}')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(bench['configs'][0], name='softras_sphere3k_1024',
                                 file='benchmark/configs/softras_sphere3k_1024.json'))
    bench['workloads'].append({'name': 'softras_sphere3k_1024.frames1',
                               'config': 'softras_sphere3k_1024', 'traffic': 'frames1',
                               'chips': 1, 'why': 'one view a request'})
    bench['end_to_end'] = [dict(m, workloads=m['workloads'] + ['softras_sphere3k_1024.frames1'])
                           if 'frames_per_s' == m['name'] or 'frame_p95_ms' == m['name'] else m
                           for m in bench['end_to_end']]
    bench['per_layer'].append({'name': 'binning_ms.render', 'unit': 'ms', 'better': 'lower',
                               'source': 'device_trace', 'layer': 'binning',
                               'moves': 'frames_per_s'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    _every_name_resolves(root)
    cell = registry.Cell(registry.load_benchmark(root), 'softras_sphere3k_1024.frames1', root)
    assert cell.config['mesh']['uv_sphere']['rings'] == 38
    assert cell.traffic['views'] == 1
    assert 'binning_ms.render' in [m['name'] for m in cell.per_layer]
    assert cell.metric_reader('binning_ms.render')({}) is None
    assert cell.program_module().program and cell.reference_module().render
    after = _tree(root / 'benchmark')
    assert all(after[p] == before[p] for p in before)


def test_unknown_kind_names_its_file(tmp_path):
    root, _ = _checkout(tmp_path)
    b = root / 'benchmark'
    (b / 'traffic' / 'fit8.json').write_text(json.dumps(
        dict(json.loads((b / 'traffic' / 'fit8.json').read_text()), kind='sweep')))
    cell = registry.Cell(registry.load_benchmark(root), 'softras_sphere39k_1024.fit8', root)
    with pytest.raises(FileNotFoundError, match=r'kinds/sweep\.py is missing'):
        cell.kind_module()


def test_a_kind_that_is_not_a_mesh_needs_no_edit(tmp_path, torch_threads):
    """Copy the benchmark and add, as new files and entries, a NeRF
    configuration at the port's parity size, a kind that drives the port's
    NeRF train step (``tests/nerf_addition/kinds/nerf_fit.py``), its
    reference, a mix, limits and a cell with a per-layer metric; every name
    resolves as in the benchmark itself.  A run on the CPU is correct and
    reports the cell's end-to-end metrics; with the kind's ``half`` fault
    planted (half of each step's rays) it is not, nor with ``unchanged``
    (the program's optimizer frozen); no file that was there changes."""
    root, before = _checkout(tmp_path)
    b = root / 'benchmark'
    added = [p.relative_to(NERF) for p in NERF.rglob('*')
             if p.is_file() and '__pycache__' not in p.parts]
    for rel in added:
        assert not (b / rel).exists(), rel
        shutil.copy(NERF / rel, b / rel)
    name = 'nerf_tiny.nerf_fit3'
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'nerf_tiny', 'source': 'https://github.com/bmild/nerf configs/lego.txt',
        'file': 'benchmark/configs/nerf_tiny.json',
        'reduced': ['netdepth', 'netwidth', 'N_rand', 'N_samples', 'N_importance'],
        'why': 'a configuration that is not a mesh, at the parity size of the NeRF tests'})
    bench['workloads'].append({'name': name, 'config': 'nerf_tiny', 'traffic': 'nerf_fit3',
                               'chips': 1, 'why': 'NeRF train steps, 64 rays of 16 x 16 images'})
    bench['end_to_end'] = [dict(m, workloads=m['workloads'] + [name])
                           if m['name'] == 'step_ms' else m for m in bench['end_to_end']]
    bench['per_layer'].append({'name': 'host_ms.nerf', 'unit': 'ms', 'better': 'lower',
                               'source': 'host_clock', 'layer': 'the NeRF train step',
                               'moves': 'step_ms', 'workloads': [name]})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    _every_name_resolves(root)
    cell = registry.Cell(registry.load_benchmark(root), name, root)
    assert [m['name'] for m in cell.per_layer] == ['host_ms.nerf']
    r = runner.run_cell(cell, 2 ** 31 + 99, 0.3, False, 'cpu', time.perf_counter(),
                        str(tmp_path))
    assert r['correct'], r['checks']
    assert set(r['metrics']) == {'step_ms', 'peak_mem_gib', 'setup_s'}
    assert r['attempted'] >= 1 and list(r['checks']) == ['loss', 'grad', 'change']
    kind = cell.kind_module()
    failed = {}
    for fault in ('half', 'unchanged'):
        with kind.FAULTS[fault](cell.program_module().program(cell.config, 'cpu')) as broken:
            r = runner.run_cell(cell, 2 ** 31 + 99, 0.3, False, 'cpu', time.perf_counter(),
                                str(tmp_path), build_program=lambda cfg, device: broken)
        assert not r['correct'], (fault, r['checks'])
        failed[fault] = {k for k, c in r['checks'].items() if not c['value'] <= c['limit']}
    # the reference steps a torch.optim.Adam, so a frozen state shows in the change too
    assert 'change' in failed['unchanged'], failed
    after = _tree(b)
    assert all(after[p] == before[p] for p in before)
