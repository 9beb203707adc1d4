#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 18 alone on one CUDA card: the Hopper probes
of the TPU tools (``chip_smoke.probe_phase``).

    python3 tools/run_probe_phase.py [--reps N]

T1 (``tools/exp_torch_micro.py``: tools/exp_micro.py's eight cases, the
products in both builds), T2 (``tools/exp_torch_bwd_dma.py``:
tools/exp_bwd_dma.py's five variants that trace, the products in three
builds) against their plain versions, and T3 (``tools/profile_torch_bwd.py``:
the px_f backward by stage on the 288- and 39,474-face spheres at 1024
px), with the same checks as ``chip_smoke.py``.  Builds the kernels it
runs; phase 18 prints the probes' registers and blocks an SM (their
occupancy queries).  Prints phase 18's log lines and one JSON line of its
numbers beside the card's name and power limit; exits 1 when a check
fails.

Needs a card (exits 2 without one).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('run_probe_phase: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.probes import bwd_dma, micro

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    C.log(f'{torch.cuda.get_device_name(0)}  torch {torch.__version__} cuda {torch.version.cuda}')
    C.log(smi)
    t0 = time.time()
    builds = [('softras_fwd', ()), ('softras_pxf_fwd', ()), ('softras_pxf_bwd', ()),
              ('segment_sum', ()), (micro.SOURCE, ()), (micro.SOURCE, micro.FFMA_DEFINES)] + \
        [(bwd_dma.SOURCE, bwd_dma.dot_defines(d)) for d in bwd_dma.DOTS]
    _build.build(builds)
    C.log(f'build: {time.time() - t0:.1f} s')
    t0 = time.time()
    out = C.probe_phase(dict(repo=REPO, smi=smi, reps=args.reps))
    C.log(json.dumps({'phase18': out, 'seconds': time.time() - t0, 'card': smi}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
