"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  One process: set-up (imports, the card, the
inputs from the seed, the program's kernels built or loaded from
``jrender_tpu_torch/_build/``, the warm-up, which for a fit cell is the
steps the reference follows), then the window of ``--seconds``, then the
check against the plain reference.  With ``--trace 0`` the metrics are the
cell's end-to-end ones; with ``--trace 1`` the per-layer ones, read from a
torch.profiler trace of a fixed number of steps or requests.  The last line
of standard output is the JSON result; the numbers compared, each beside
its limit, are the last lines of standard error.  With no CUDA device, too
few of them, or a module of JAX or of the JAX package loaded, the run
prints no result and exits with another code than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path) -> None:
    """Every kernel cache at a fixed place inside the checkout (the
    package's own nvcc builds already go to ``jrender_tpu_torch/_build/``)."""
    base = root / '.bench_cache'
    os.environ['TRITON_CACHE_DIR'] = str(base / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(base / 'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = str(base / 'cuda')


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else 'not read'
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return 'not read'


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('run.py: no CUDA device; the benchmark runs on the card only', file=sys.stderr)
        return 2
    from benchmark.harness import guard, registry, runner
    cell = registry.Cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    if torch.cuda.device_count() < cell.entry['chips']:
        print(f'run.py: {args.workload} needs {cell.entry["chips"]} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                             T_START, tmp=tempfile.gettempdir())
    result['device']['power'] = power_limit()
    bad = guard.forbidden_modules()
    if bad:
        print(f'run.py: modules of JAX or the JAX package were loaded: {", ".join(bad)}',
              file=sys.stderr)
        return 3
    checks = result.pop('checks')
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    result['checks'] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
