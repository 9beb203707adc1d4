"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 10,11,12] [--faults half,altered,vertex_grad]

For each of ``--seeds`` the program's check numbers as a run makes them
(a fit cell: its set-up steps against the reference; a frames cell: its
warm-up and three requests, the last compared); for each of
``--control-seeds`` the control's: the reference itself in bfloat16, the
nearest precision below the configuration's float32, in the program's
place; for each of ``--fault-seeds`` the numbers of the program with each
of ``--faults`` planted (``harness/faults.py``).  One JSON line each on
standard output; a fit cell's line also gives each leaf's norms (the
compared side's and the reference's) of the first gradients and of the
change, which the ``grad`` and ``change`` gaps are worked out from.  It
runs on the card only, and the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


DEVICE = 'cuda'


def leaf_norms(got: dict, ref: dict) -> dict:
    """Per leaf (offsets, textures): [norm of the compared side, norm of
    the reference] of the first gradients and of the change."""
    import torch

    def n(x):
        return float(torch.linalg.vector_norm(x.double()))
    return {k: [[n(a), n(b)] for a, b in zip(got[k], ref[k])] for k in ('grads', 'change')}


def fit_readings(got: dict, ref: dict) -> dict:
    from benchmark.harness import check
    return dict(check.fit_numbers(got, ref), leaves=leaf_norms(got, ref))


def program_numbers(cell, prog, seed: int) -> dict:
    from benchmark.harness import check, traffic
    cfg, mix, ref = cell.config, cell.traffic, cell.reference_module()
    inp = traffic.make_inputs(cfg, mix, seed, DEVICE)
    if mix['kind'] == 'fit':
        step = traffic.FitStep(prog, inp, mix)
        record = traffic.fit_setup(step, mix)
        del step
        return fit_readings(record, check.reference_fit(ref, cfg, inp, mix))
    frames = traffic.Frames(prog, inp)
    for _ in range(mix['warmup_requests'] + 2):
        frames()
    k = frames.k
    out = frames()
    del frames
    return check.frames_numbers(out, check.reference_frames(ref, cfg, inp, k))


def control_numbers(cell, seed: int) -> dict:
    import torch
    from benchmark.harness import check, traffic
    cfg, mix, ref = cell.config, cell.traffic, cell.reference_module()
    inp = traffic.make_inputs(cfg, mix, seed, DEVICE)
    if mix['kind'] == 'fit':
        low = check.reference_fit(ref, cfg, inp, mix, torch.bfloat16)
        return fit_readings(low, check.reference_fit(ref, cfg, inp, mix))
    k = mix['warmup_requests'] + 2
    low = check.reference_frames(ref, cfg, inp, k, torch.bfloat16)
    return check.frames_numbers(low, check.reference_frames(ref, cfg, inp, k))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--faults', default='half,altered,vertex_grad')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('calibrate.py: no CUDA device; limits are set from the card only', file=sys.stderr)
        return 2
    from benchmark.harness import faults, registry
    cell = registry.Cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    make = cell.program_module().program
    prog = make(cell.config, DEVICE)

    def seeds(s):
        return [int(x) for x in s.split(',') if x]

    def emit(what, seed, numbers, t0):
        print(json.dumps({'cell': cell.name, 'what': what, 'seed': seed, 'numbers': numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        emit('program', seed, program_numbers(cell, prog, seed), t0)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit('control', seed, control_numbers(cell, seed), t0)
    for name in [f for f in args.faults.split(',') if f]:
        broken = faults.PROGRAM_FAULTS[name](prog)
        for seed in seeds(args.fault_seeds):
            t0 = time.perf_counter()
            emit(f'fault:{name}', seed, program_numbers(cell, broken, seed), t0)
    return 0


if __name__ == '__main__':
    sys.exit(main())
