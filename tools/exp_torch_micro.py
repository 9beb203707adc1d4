#!/usr/bin/env python3
"""What a px_f-style grid step costs on the card: the counterpart of
``tools/exp_micro.py`` (T1), run on the Hopper probe
``jrender_tpu_torch/probes/micro.py`` (csrc/probe_micro.cu).

    python3 tools/exp_torch_micro.py [--reps N]

The TPU probe's eight cases on its N = 838 steps of [16, 128] blocks (data
uniform in [0, 1) from a numpy generator seeded 0), each held to its plain
version on the card, and the dot case in both builds (tensor cores, FFMA).
The plain version does the kernel's FMAs in the kernel's order, so a case
without products must give its bits exactly (out, the steps' rows, the dot
rows), and the check first shows that the plain version with one pair op
fewer gives other steps' rows; a case with products holds them within rtol
1e-5 (their sums run in other orders).  A full-width case whose pair count
is not a multiple of the kernel's unroll (4) checks the chain's tail.
Each case is timed by its kernels' own device time (``device_ms``: the
step kernel and the sum in step order) and by CUDA events around the
wrapper, beside its plain version's time and its bound.  Then the fit of
the step kernel's time against the pair ops (pair20 / pair100 / pair300):
the fixed cost of a step (on the card, where many blocks run at once, and
of one block: that times the blocks resident at once) and the cost of a
pair op; and what a product adds to a step in each build.  Prints the TPU
probe's lines and one JSON line beside the card's name and power limit.
Imports neither JAX nor ``bench.py``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from chip_smoke import bound  # noqa: E402
from jrender_tpu_torch.probes import micro  # noqa: E402

KERNELS = {'step': ('probe_micro_kernel',), 'sum': ('probe_micro_sum_kernel',)}
SMS = 132   # streaming multiprocessors of an H100 SXM
SEED = 0
# checked, not timed: a pair count that is not a multiple of the unroll
TAIL = ('pair23_face7_slice9', (23, 7, 9, 0, micro.T2))


def _rel_err(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def check(got: micro.MicroOut, data, case, tag: str) -> tuple[float, float]:
    """(the largest relative, the largest absolute error) of out, the rows
    and the dot rows against the plain version; raises where a case
    without products differs in a bit (or its check could not see one pair
    op fewer in the steps' rows: out, the rows' sum, may round it away) or
    a case with products lies beyond rtol 1e-5."""
    n_pair, n_face, n_slice, n_dot, t2 = case
    want = micro.run_plain(data, n_pair, n_face, n_slice, n_dot, t2)
    if n_dot == 0:
        if n_pair and torch.equal(
                micro.run_plain(data, n_pair - 1, n_face, n_slice, n_dot, t2).partial,
                want.partial):
            raise AssertionError(f'T1 {tag}: one pair op fewer gives the same bits')
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f'T1 {tag}: the kernel differs from its plain version in bits')
    err = max(_rel_err(got.out, want.out), _rel_err(got.partial, want.partial),
              _rel_err(got.dots, want.dots) if want.dots.abs().max() > 0 else
              got.dots.abs().max().item())
    if not err <= 1e-5:
        raise AssertionError(f'T1 {tag}: the kernel is {err:.3g} from its plain version')
    return err, max((a - b).abs().max().item() for a, b in zip(got, want))


def fit(xs, ys):
    """(intercept, slope) of the least-squares line through (xs, ys)."""
    b, a = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(a), float(b)


def measure(reps: int = 20) -> dict:
    """Every case and both dot builds on the card, held to the plain
    version, and the tail case; the fits.  Raises on a difference."""
    from jrender_tpu_torch.utils.device_time import device_ms, events_ms
    data = torch.tensor(np.random.RandomState(SEED).uniform(
        size=(micro.N, micro.ROWS, micro.FB)).astype(np.float32), device='cuda')
    tail = dict(zip(('max_rel_err', 'max_abs_err'),
                    check(micro.launch_micro(data, *TAIL[1]), data, TAIL[1], TAIL[0])))
    cases = [(name, args, False) for name, args in micro.CASES]
    cases.append(('pair20_dot25_ffma', dict(micro.CASES)['pair20_dot25'], True))
    out = {}
    for name, (n_pair, n_face, n_slice, n_dot, t2), ffma in cases:
        run = lambda: micro.launch_micro(data, n_pair, n_face, n_slice, n_dot, t2, ffma)  # noqa: E731
        plain = lambda: micro.run_plain(data, n_pair, n_face, n_slice, n_dot, t2)  # noqa: E731
        err, abs_err = check(run(), data, (n_pair, n_face, n_slice, n_dot, t2), name)
        again = run()
        if not torch.equal(again.out, run().out):
            raise AssertionError(f'T1 {name}: two runs differ in their bits')
        dms = device_ms(run, KERNELS, reps=reps)
        ops, nbytes = micro.work(n_pair, n_face, n_slice, n_dot, t2)
        b = bound(ops, nbytes)
        out[name] = {'n_pair': n_pair, 'n_face': n_face, 'n_slice': n_slice, 'n_dot': n_dot,
                     'T2': t2, 'build': 'ffma' if ffma else 'mma', 'max_rel_err': err,
                     'max_abs_err': abs_err,
                     'device_ms': dms['step'] + dms['sum'], 'step_ms': dms['step'],
                     'sum_ms': dms['sum'], 'ms': events_ms(run, reps),
                     'plain_ms': events_ms(plain, 3), 'bound_ms': b[0], 'bound_by': b[1],
                     'ops': ops, 'bytes': nbytes,
                     'us_per_step': dms['step'] * 1e3 / micro.N}
    occ = {t2: micro.occupancy(t2) for t2 in (1024, 256)}
    occ_ffma = micro.occupancy(1024, ffma=True)
    fits = {}
    for t2, names in ((1024, ('pair20', 'pair100', 'pair300')),
                      (256, ('pair100_T2=256', 'pair300_T2=256'))):
        a, b = fit([out[n]['n_pair'] for n in names], [out[n]['step_ms'] for n in names])
        resident = SMS * occ[t2]['blocks_per_sm']
        fits[f'T2={t2}'] = {
            'cases': list(names), 'fixed_ms': a, 'ms_per_pair_op': b,
            'fixed_us_per_step': a * 1e3 / micro.N,
            'fixed_us_per_block': a * 1e3 / micro.N * resident,
            'ns_per_pair_op': b * 1e6 / (micro.N * t2 * micro.FB),
            'pair_ops_per_s': micro.N * t2 * micro.FB / (b * 1e-3) if b > 0 else None,
            'resident_blocks': resident}
    # a product's cost: the 25 products' time over pair20's (the pair chain
    # hides part of the products, which run on other units)
    dots = {}
    for k, n in (('mma', 'pair20_dot25'), ('ffma', 'pair20_dot25_ffma')):
        extra = out[n]['step_ms'] - out['pair20']['step_ms']
        dots[k] = {'ms_per_dot': extra / 25, 'us_per_dot_per_step': extra / 25 * 1e3 / micro.N}
    return {'cases': out, 'tail': {'case': TAIL[0], **tail}, 'fit': fits, 'dots': dots, 'occupancy': {**occ, 'ffma_1024': occ_ffma},
            'launches': micro.launch_micro.launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('exp_torch_micro: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from jrender_tpu_torch import _build
    t0 = time.time()
    _build.build([micro.SOURCE, (micro.SOURCE, micro.FFMA_DEFINES)])
    print(f'build: {time.time() - t0:.1f} s', flush=True)
    r = measure(args.reps)
    for name, c in r['cases'].items():
        ms = c['device_ms']
        print(f'{name:18s}: {ms:7.4f} ms total, {ms / micro.N * 1e3:7.4f} us/step '
              f'(wrapper {c["ms"]:.4f} ms, bound {c["bound_ms"]:.4f} ms by {c["bound_by"]})',
              flush=True)
    print(json.dumps({**r, 'card': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
