"""Names in ``BENCHMARK.json`` to the files that hold them.

A cell names a configuration and a traffic mix; a per-layer metric names
its reader.  Each is found by its name alone, so a later change adds a
configuration, a mix, a cell or a metric by adding files and entries:

  configuration  the entry's ``file`` (``configs/<config>.json``, the
                 sizes as run), ``configs/<config>.py`` (the system under
                 test, driven at those sizes) and ``reference/<config>.py``
                 (its plain reference)
  traffic mix    ``traffic/<traffic>.json``, whose ``kind`` names
                 ``kinds/<kind>.py``: the module that makes the mix's
                 inputs from the seed, drives its calls, set-up and window,
                 and works out its check (``benchmark/README.md``)
  metric         ``metrics/<name>.py``, else ``metrics/<base>.py`` with
                 ``<base>`` the name before its first dot (``host_ms.fit``
                 and ``host_ms.render`` share ``metrics/host_ms.py``)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f'{path} is missing')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with what it names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json; '
                           f'there are {", ".join(sorted(cells))}')
        self.entry = cells[name]
        self.name = name
        self.root = root
        self.bench_dir = root / 'benchmark'
        configs = {c['name']: c for c in bench['configs']}
        self.config_entry = configs[self.entry['config']]
        self.config = json.loads((root / self.config_entry['file']).read_text())
        self.traffic = json.loads(
            (self.bench_dir / 'traffic' / f'{self.entry["traffic"]}.json').read_text())
        self.end_to_end = [m for m in bench['end_to_end'] if self.reports(m)]
        moved = {m['name'] for m in self.end_to_end}
        # a per-layer metric with ``workloads`` is read in those cells; one
        # without it in every cell that reports the metric it moves
        self.per_layer = [m for m in bench['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in moved)]

    def reports(self, metric: dict) -> bool:
        return self.name in metric.get('workloads', [self.name])

    def program_module(self):
        c = self.entry['config']
        return load_module(self.bench_dir / 'configs' / f'{c}.py', f'bench_config_{c}')

    def kind_module(self):
        kind = self.traffic['kind']
        path = self.bench_dir / 'kinds' / f'{kind}.py'
        if not path.is_file():
            raise FileNotFoundError(f'the traffic mix {self.entry["traffic"]!r} is of the kind '
                                    f'{kind!r}, and {path} is missing')
        return load_module(path, f'bench_kind_{kind}')

    def reference_module(self):
        c = self.entry['config']
        return load_module(self.bench_dir / 'reference' / f'{c}.py', f'bench_reference_{c}')

    def metric_reader(self, name: str):
        return metric_reader(self.bench_dir, name)


def metric_reader(bench_dir: Path, name: str):
    """The ``read`` function of a per-layer metric's reader."""
    for stem in (name, name.split('.')[0]):
        path = bench_dir / 'metrics' / f'{stem}.py'
        if path.is_file():
            return load_module(path, f'bench_metric_{stem.replace(".", "_")}').read
    raise FileNotFoundError(f'no reader for the metric {name!r} under {bench_dir / "metrics"}')
