#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16 alone on one CUDA card: volume rendering
and NeRF at the lego config's full width (``chip_smoke.nerf_stack``).

    python3 tools/run_nerf_phase.py

One lego batch on the card against the CPU, ``bench.py``'s NeRF row on the
port (140 steps on its 400² target: ms per step, rays a second, the
device time split between matrix products and the rest, peak memory, the
PSNR rise), a full 400² frame twice, and the trainer (a checkpoint and a
resume, ``--profile_dir``, bf16), with the same checks as
``chip_smoke.py``.  The NeRF path builds no kernel.  Prints phase 16's log
lines and one JSON line of its numbers beside the card's name and power
limit; exits 1 when a check fails.

Needs a card (exits 2 without one).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('run_nerf_phase: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    C.log(f'{torch.cuda.get_device_name(0)}  torch {torch.__version__} cuda {torch.version.cuda}')
    C.log(smi)
    t0 = time.time()
    out = C.nerf_stack(dict(dev=torch.device('cuda'), smi=smi, zero_counts=lambda: None,
                            read_all=lambda: 0))
    C.log(json.dumps({'phase16': out, 'seconds': time.time() - t0, 'card': smi}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
