"""Fixtures of the benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on a machine with no card; a test that needs one is marked
``gpu`` and skips inside the ``card`` fixture where there is none.  Cells
are cut to a size the CPU holds (64 px, a sphere of 308 faces, 2 views),
where the program runs its plain PyTorch versions.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA device; skips inside the test without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')


def small_cell(name, size=64, rings=12, segs=14, views=2):
    """The cell ``name`` of BENCHMARK.json at a size the CPU holds."""
    from benchmark.harness import registry
    cell = registry.Cell(registry.load_benchmark(ROOT), name, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg['mesh']['uv_sphere'].update(rings=rings, segs=segs)
    cfg['image_size'] = cfg['render']['image_size'] = size
    cfg['faces'] = (rings - 1) * segs * 2
    cfg['vertices'] = (rings + 1) * segs
    cell.config = cfg
    cell.traffic = dict(cell.traffic, views=views)
    return cell


@pytest.fixture
def torch_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
