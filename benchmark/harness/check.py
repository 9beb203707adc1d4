"""The comparison that decides ``correct``: what the timed path produced
against the configuration's plain reference, after the window.

Each traffic kind (``kinds/<kind>.py``) works out its own numbers, from
what its run kept and from the reference following the same inputs; the
helpers here are for any kind.  A leaf's gap is |norm(program) -
norm(reference)| over the larger of the reference's norm of that leaf and
of the median leaf (``norm_gap``); an image's, the share of places off
(``pixel_share``).  Each number's limit is in ``limits/<cell>.json``.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

ATOL = 1e-4      # a pixel's output beyond atol + rtol * |reference| is off
RTOL = 1e-4


def norm_gap(prog: list, ref: list, ref_grads: list | None = None) -> float:
    pn = [float(torch.linalg.vector_norm(x.double())) for x in prog]
    rn = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    med = statistics.median(rn)
    keep = range(len(rn))
    if ref_grads is not None:
        gn = [float(torch.linalg.vector_norm(x.double())) for x in ref_grads]
        keep = [i for i in keep if gn[i] >= 1e-3 * statistics.median(gn)]
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in keep)


def pixel_share(prog: dict, ref: dict) -> float:
    """The share of (view, pixel) places where some output differs from the
    reference's by more than ATOL + RTOL * |reference|; a view or an output
    the program did not give, and a value that is not finite, is off."""
    bad = None
    for k, r in ref.items():
        r = r.to(torch.float64)
        p = torch.full_like(r, math.nan)
        if k in prog:
            got = prog[k].to(r.device, torch.float64)[:r.shape[0]]
            p[:got.shape[0]] = got
        off = ~((p - r).abs() <= ATOL + RTOL * r.abs())
        if off.dim() == 4:                      # [N,C,H,W] -> [N,H,W]
            off = off.any(dim=1)
        bad = off if bad is None else bad | off
    return float(bad.double().mean())


def load_limits(bench_dir: Path, cell: str) -> dict:
    return json.loads((bench_dir / 'limits' / f'{cell}.json').read_text())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite fails."""
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, checks
