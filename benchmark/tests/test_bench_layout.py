"""Every name in BENCHMARK.json resolves to its files, and a configuration,
a traffic mix, a cell and a metric are added by new files and entries
alone."""
import json
import shutil

from benchmark.harness import registry

from conftest import ROOT


def test_every_name_resolves():
    bench = registry.load_benchmark(ROOT)
    for w in bench['workloads']:
        cell = registry.Cell(bench, w['name'], ROOT)
        assert cell.traffic['kind'] in ('fit', 'frames')
        assert hasattr(cell.program_module(), 'program')
        ref = cell.reference_module()
        assert all(hasattr(ref, f) for f in ('render', 'census', 'least_work'))
        assert (ROOT / 'benchmark' / 'limits' / f'{w["name"]}.json').is_file()
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m['name']))
    for c in bench['configs']:
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['name'] == c['name']


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


def test_additions_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell and a metric
    as new files and entries, and find each by its name; no file that was
    there changes."""
    root = tmp_path / 'checkout'
    shutil.copytree(ROOT / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    before = _tree(root / 'benchmark')
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

    cell = registry.Cell(registry.load_benchmark(root), 'softras_sphere3k_1024.frames1', root)
    assert cell.config['mesh']['uv_sphere']['rings'] == 38
    assert cell.traffic['views'] == 1
    assert 'binning_ms.render' in [m['name'] for m in cell.per_layer]
    assert cell.metric_reader('binning_ms.render')({}) is None
    assert cell.program_module().program and cell.reference_module().render
    after = _tree(root / 'benchmark')
    assert all(after[p] == before[p] for p in before)
