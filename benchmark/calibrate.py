"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 10,11,12] [--faults half,altered]

Each number comes from the cell's traffic kind (``kinds/<kind>.py``).  For
each of ``--seeds`` the program's check numbers as a run makes them
without its window (the kind's ``sample``: a fit cell's set-up steps
against the reference; a frames cell's warm-up and three requests, the
last compared); for each of ``--control-seeds`` the control's: the
reference itself in bfloat16, the nearest precision below the
configuration's float32, in the program's place; for each of
``--fault-seeds`` the numbers of the program with each of ``--faults``
(default: every fault in the kind's ``FAULTS``) planted.  One JSON line
each on standard output; a fit cell's line also gives each leaf's norms
(the compared side's and the reference's) of the first gradients and of
the change, which the ``grad`` and ``change`` gaps are worked out from.
It runs on the card only, and the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


DEVICE = 'cuda'


def program_numbers(cell, kind, prog, seed: int) -> dict:
    """The program's check numbers, as a run makes them without its window."""
    cfg, mix = cell.config, cell.traffic
    inp = kind.make_inputs(cfg, mix, seed, DEVICE)
    call = kind.Call(prog, inp, mix)
    kept = kind.sample(call, mix)
    del call
    return kind.numbers(cfg, mix, cell.reference_module(), inp, kept, readings=True)


def control_numbers(cell, kind, seed: int) -> dict:
    import torch
    cfg, mix = cell.config, cell.traffic
    inp = kind.make_inputs(cfg, mix, seed, DEVICE)
    return kind.control_numbers(cfg, mix, cell.reference_module(), inp, torch.bfloat16,
                                readings=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--faults', default=None,
                    help='comma-separated names of the kind\'s faults (default: all of them)')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('calibrate.py: no CUDA device; limits are set from the card only', file=sys.stderr)
        return 2
    from benchmark.harness import registry
    cell = registry.Cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    kind = cell.kind_module()
    prog = cell.program_module().program(cell.config, DEVICE)

    def seeds(s):
        return [int(x) for x in s.split(',') if x]

    def emit(what, seed, numbers, t0):
        print(json.dumps({'cell': cell.name, 'what': what, 'seed': seed, 'numbers': numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        emit('program', seed, program_numbers(cell, kind, prog, seed), t0)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit('control', seed, control_numbers(cell, kind, seed), t0)
    names = list(kind.FAULTS) if args.faults is None else [f for f in args.faults.split(',') if f]
    for name in names:
        with kind.FAULTS[name](prog) as broken:
            for seed in seeds(args.fault_seeds):
                t0 = time.perf_counter()
                emit(f'fault:{name}', seed, program_numbers(cell, kind, broken, seed), t0)
    return 0


if __name__ == '__main__':
    sys.exit(main())
