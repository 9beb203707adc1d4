"""The comparison that decides ``correct``: what the timed path produced
against the configuration's plain reference, after the window.

A fit cell compares its first ``checked_steps`` steps, which set-up ran
through the window's own call on the window's object, with the reference
following the same steps from the same start:

  ``loss``    each step's loss, the largest relative gap;
  ``grad``    the first step's gradient norms as the optimizer got them,
              the worst leaf's gap (below);
  ``change``  the norms of the leaves' change over the steps, the worst
              leaf's gap;
  ``image``   the first step's images (``pixel_share``).

A frames cell compares the images of one request of its window, drawn from
the seed: ``image``.  A leaf's gap is |norm(program) - norm(reference)|
over the larger of the reference's norm of that leaf and of the median
leaf; a leaf whose reference gradient is under a thousandth of the median
leaf's is left out of ``change`` (it moves by round-off alone).  Each
number's limit is in ``limits/<cell>.json``.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

from benchmark.harness import traffic
from benchmark.reference import scene

ATOL = 1e-4      # a pixel's output beyond atol + rtol * |reference| is off
RTOL = 1e-4
VIEW_BLOCK = 4   # views the reference renders at once in a frames check


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


def reference_fit(ref, cfg: dict, inp: traffic.Inputs, mix: dict, dtype=torch.float32) -> dict:
    """The reference's first steps from the program's start, in ``dtype``:
    the same record as ``traffic.fit_setup`` makes of the program."""
    def cast(x):
        return x.to(dtype)
    raw = cast(inp.raw).clone().requires_grad_()
    tex = cast(inp.textures).clone().requires_grad_()
    o, t = mix['optimizer']['offsets'], mix['optimizer']['textures']
    adam = scene.Adam([raw, tex], [(o['lr'], tuple(o['betas'])), (t['lr'], tuple(t['betas']))])
    targets = {k: cast(v) for k, v in inp.targets.items()}
    template = cast(inp.template)
    losses, record = [], {}
    for k in range(mix['checked_steps']):
        vertices = template + inp.offset_scale * torch.tanh(raw)
        out = ref.render(cfg, inp.batch(vertices), inp.batch(inp.faces), inp.batch(tex),
                         cast(inp.eyes[k % traffic.TABLE]))
        loss = traffic.image_loss(out, targets)
        grads = torch.autograd.grad(loss, [raw, tex])
        adam.step(grads)
        losses.append(float(loss.detach()))
        if k == 0:
            record['grads'] = [g.float() for g in grads]
            record['images'] = {n: v.detach().float() for n, v in out.items()}
        del out, loss, grads, vertices
    record['losses'] = losses
    record['change'] = [(raw.detach() - cast(inp.raw)).float(),
                        (tex.detach() - cast(inp.textures)).float()]
    return record


def reference_frames(ref, cfg: dict, inp: traffic.Inputs, k: int, dtype=torch.float32) -> dict:
    """The reference's images of request ``k``, a few views at a time."""
    eyes = inp.eyes[k % traffic.TABLE].to(dtype)
    parts = []
    with torch.no_grad():
        for s in range(0, inp.views, VIEW_BLOCK):
            n = min(VIEW_BLOCK, inp.views - s)

            def b(x):
                return x.to(dtype).expand(n, *([-1] * (x.dim() - 1)))
            parts.append(ref.render(cfg, b(inp.template), inp.faces.expand(n, -1, -1),
                                    b(inp.textures), eyes[s:s + n]))
    return {name: torch.cat([p[name] for p in parts]).float() for name in parts[0]}


def fit_numbers(prog: dict, ref: dict) -> dict:
    return {
        'loss': max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog['losses'], ref['losses'])),
        'grad': norm_gap(prog['grads'], ref['grads']),
        'change': norm_gap(prog['change'], ref['change'], ref['grads']),
        'image': pixel_share(prog['images'], ref['images']),
    }


def frames_numbers(prog_out: dict, ref_out: dict) -> dict:
    return {'image': pixel_share(prog_out, ref_out)}


def load_limits(bench_dir: Path, cell: str) -> dict:
    return json.loads((bench_dir / 'limits' / f'{cell}.json').read_text())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite fails."""
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, checks
