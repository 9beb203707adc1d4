#!/usr/bin/env python3
"""What staging a backward work item costs on the card: the counterpart of
``tools/exp_bwd_dma.py`` (T2), run on the Hopper probe
``jrender_tpu_torch/probes/bwd_dma.py`` (csrc/probe_bwd_dma.cu).

    python3 tools/exp_torch_bwd_dma.py [--reps N]

The TPU probe's inputs (N = 3,973 items; face [N, 106, 128], px [4,096 +
18, 16, 256] uniform in [0, 1), seg sorted rows, from a numpy generator
seeded 0) and its five variants that trace (``tr256x11`` is printed as not
defined by the reference), ``dots`` in its three builds (tensor cores,
FFMA, adds).  Each is held to its plain version on the card (gout within
rtol 1e-5, the staged bits' checksums equal) and timed by the kernel's own
device time (``device_ms``) and by CUDA events around the wrapper, beside
its plain version's time and its bound.  Then the staging alone, each copy
variant's time less base's: the 16 rows by cp.async (dma16) against the
18-row range by TMA bulk copies (dma1r), per item and in copied bytes a
second.  Prints the TPU probe's lines and one JSON line beside the card's
name and power limit.  Imports neither JAX nor ``bench.py``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from chip_smoke import bound  # noqa: E402
from jrender_tpu_torch.probes import bwd_dma  # noqa: E402

KERNELS = {'item': ('probe_bwd_dma_kernel',)}


def check(got: bwd_dma.BwdDmaOut, want: bwd_dma.BwdDmaOut, tag: str) -> tuple[float, float]:
    """gout's (largest relative, largest absolute) error; raises beyond rtol
    1e-5 or where a checksum differs."""
    diff = (got.gout - want.gout).abs()
    err = (diff / want.gout.abs().clamp_min(1e-30)).max().item()
    if not err <= 1e-5:
        raise AssertionError(f'T2 {tag}: gout is {err:.3g} from its plain version')
    if not torch.equal(got.stage_sum, want.stage_sum):
        raise AssertionError(f'T2 {tag}: the checksums of the staged rows differ')
    return err, diff.max().item()


def measure(reps: int = 20) -> dict:
    """Every variant (dots in each build) on the card, held to the plain
    version; the staging's costs.  Raises on a difference."""
    from jrender_tpu_torch.utils.device_time import device_ms, events_ms
    face, px, seg = bwd_dma.inputs(device='cuda')
    runs = [(v, 'mma') for v in bwd_dma.VARIANTS] + [('dots', 'ffma'), ('dots', 'adds')]
    out = {}
    for variant, dot in runs:
        name = variant if dot == 'mma' else f'{variant}_{dot}'
        run = lambda: bwd_dma.launch_bwd_dma(face, px, seg, variant, dot)  # noqa: E731
        plain = lambda: bwd_dma.run_plain(face, px, seg, variant)  # noqa: E731
        want = plain()
        err, abs_err = check(run(), want, name)
        if not torch.equal(run().gout, run().gout):
            raise AssertionError(f'T2 {name}: two runs differ in their bits')
        dms = device_ms(run, KERNELS, reps=reps)['item']
        moved = bwd_dma.moved_bytes(seg, variant)
        b = bound(0, moved['once'])
        out[name] = {'variant': variant, 'build': dot, 'max_rel_err': err,
                     'max_abs_err': abs_err, 'device_ms': dms,
                     'us_per_item': dms * 1e3 / bwd_dma.N, 'ms': events_ms(run, reps),
                     'plain_ms': events_ms(plain, 2), 'bound_ms': b[0], 'bound_by': b[1],
                     'bytes_once': moved['once'], 'bytes_copied': moved['copied'],
                     'copied_gb_per_s': moved['copied'] / (dms * 1e-3) / 1e9}
    base = out['base']['device_ms']
    staging = {k: {'route': r, 'rows_per_item': rows,
                   'us_per_item': (out[k]['device_ms'] - base) * 1e3 / bwd_dma.N,
                   'row_gb_per_s': bwd_dma.N * rows * bwd_dma.PX_C * bwd_dma.T2 * 4
                   / ((out[k]['device_ms'] - base) * 1e-3) / 1e9
                   if out[k]['device_ms'] > base else None}
               for k, r, rows in (('dma16', 'cp.async', bwd_dma.GPI),
                                  ('dma1r', 'TMA bulk copies', bwd_dma.NTR))}
    return {'variants': out, 'staging': staging, 'undefined': list(bwd_dma.UNDEFINED),
            'occupancy': {d: bwd_dma.occupancy(d) for d in bwd_dma.DOTS},
            'launches': bwd_dma.launch_bwd_dma.launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('exp_torch_bwd_dma: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from jrender_tpu_torch import _build
    t0 = time.time()
    _build.build([(bwd_dma.SOURCE, bwd_dma.dot_defines(d)) for d in bwd_dma.DOTS])
    print(f'build: {time.time() - t0:.1f} s', flush=True)
    r = measure(args.reps)
    for name, c in r['variants'].items():
        ms = c['device_ms']
        print(f'{name:10s}: {ms:8.4f} ms  ({c["us_per_item"]:.4f} us/item; wrapper '
              f'{c["ms"]:.4f} ms, bound {c["bound_ms"]:.4f} ms by {c["bound_by"]})', flush=True)
    for v in r['undefined']:
        print(f'{v:10s}: not defined by the reference (the TPU probe does not trace it)',
              flush=True)
    print(json.dumps({**r, 'card': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
