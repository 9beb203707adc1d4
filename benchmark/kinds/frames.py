"""The traffic kind ``frames``: one request of ``views`` views a call, with
no gradient, ended by ``torch.cuda.synchronize()``, a closed loop with one
caller.

A request renders consecutive frames of a turntable at
``degrees_per_frame``, each request going on where the last ended, from
the phase of ``harness/mesh.py`` (the seed draws nothing after it).  The
check compares the images of one request of the window, drawn from the
seed, with the reference's (``image``, ``check.pixel_share``).
"""
from __future__ import annotations

import math
import random
import time

import torch

from benchmark.harness import check, faults, mesh
from benchmark.harness.traffic import sync

HOST_COUNT = 'host_requests'        # the mix's count of requests that host_ms times
TRACED_COUNT = 'traced_requests'    # and of requests that the profiler sees
VIEW_BLOCK = 4                      # views the reference renders at once

REFERENCE = ('render', 'census', 'least_work')    # what reference/<config>.py gives

FAULTS = {
    'half': faults.wrapping(faults.HalfBatch),
    'altered': faults.wrapping(faults.Altered),
}


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> mesh.Inputs:
    def azimuths(phase, k, j, g):
        return phase + mix['degrees_per_frame'] * (k * mix['views'] + j)
    return mesh.make_inputs(cfg, mix, seed, device, azimuths)


class Call:
    """One call = one request of the mix: the next ``views`` frames, ended
    by a synchronize.  ``enqueue`` is the request without that synchronize:
    what the host does before it waits for the card.  ``kept`` is (request
    number, its outputs) of the request the check compares."""

    def __init__(self, prog, inp: mesh.Inputs, mix: dict):
        self.prog, self.inp = prog, inp
        self.k = 0
        self.kept = None

    def enqueue(self):
        inp = self.inp
        with torch.no_grad():
            out = self.prog.render(inp.batch(inp.template), inp.batch(inp.faces),
                                   inp.batch(inp.textures), inp.eyes[self.k % mesh.TABLE])
        self.k += 1
        return out

    def __call__(self):
        out = self.enqueue()
        sync(self.inp.template.device)
        return out


def setup(frames: Call, mix: dict) -> str:
    """The warm-up: ``warmup_requests`` requests."""
    for _ in range(mix['warmup_requests']):
        frames()
    return ''


def window(frames: Call, seconds: float, seed: int) -> tuple[int, dict]:
    """Requests back to back for ``seconds``; each request's latency from
    its start to its synchronize.  One request's outputs, drawn from the
    seed by reservoir sampling, are kept for the check.  (requests,
    {frames_per_s, frame_p95_ms})."""
    rng = random.Random(seed)
    lat, kept = [], None
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        k = frames.k
        out = frames()
        lat.append(time.perf_counter() - a)
        if rng.random() * len(lat) < 1.0:
            kept = (k, out)
        del out
    t = time.perf_counter() - t0
    lat_sorted = sorted(lat)
    frames.kept = kept
    return len(lat), {
        'frames_per_s': frames.inp.views * len(lat) / t,
        'frame_p95_ms': lat_sorted[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)] * 1e3}


class Keeper:
    """A frames call that keeps one request's outputs of the traced window,
    drawn from the seed by reservoir sampling (the two calls before the
    window's ranges are not drawn from)."""

    def __init__(self, frames: Call, n: int, seed: int):
        self.frames, self.rng, self.seen, self.kept = frames, random.Random(seed), -2, None

    @property
    def k(self):
        return self.frames.k

    def __call__(self):
        k = self.frames.k
        out = self.frames()
        self.seen += 1
        if self.seen >= 1 and self.rng.random() * self.seen < 1.0:
            self.kept = (k, out)
        return out


def traced_call(frames: Call, n: int, seed: int) -> Keeper:
    """The call the profiler drives."""
    return Keeper(frames, n, seed)


def layer_context(cell, prog, ref, inp, keeper: Keeper, tr, host, n, first) -> dict:
    """The readers count the work of the template and its textures."""
    return mesh.layer_context(cell, prog, ref, inp, (inp.template, inp.textures), tr, host, n,
                              first, fit=False)


def sample(frames: Call, mix: dict):
    """What a run keeps for its check, made without a window: the request
    after the warm-up and two more."""
    for _ in range(mix['warmup_requests'] + 2):
        frames()
    k = frames.k
    return k, frames()


def reference(ref, cfg: dict, inp: mesh.Inputs, k: int, dtype=torch.float32) -> dict:
    """The reference's images of request ``k``, a few views at a time."""
    eyes = inp.eyes[k % mesh.TABLE].to(dtype)
    parts = []
    with torch.no_grad():
        for s in range(0, inp.views, VIEW_BLOCK):
            n = min(VIEW_BLOCK, inp.views - s)

            def b(x):
                return x.to(dtype).expand(n, *([-1] * (x.dim() - 1)))
            parts.append(ref.render(cfg, b(inp.template), inp.faces.expand(n, -1, -1),
                                    b(inp.textures), eyes[s:s + n]))
    return {name: torch.cat([p[name] for p in parts]).float() for name in parts[0]}


def compare(got: dict, want: dict, readings: bool = False) -> dict:
    """The check's numbers of images ``got`` against the reference's."""
    return {'image': check.pixel_share(got, want)}


def numbers(cfg: dict, mix: dict, ref, inp: mesh.Inputs, kept, readings: bool = False) -> dict:
    """The program's check numbers: the kept request against the reference."""
    k, out = kept
    return compare(out, reference(ref, cfg, inp, k))


def control_numbers(cfg: dict, mix: dict, ref, inp: mesh.Inputs, dtype,
                    readings: bool = False) -> dict:
    """The control's: the reference in ``dtype`` in the program's place, on
    the request that ``sample`` keeps."""
    k = mix['warmup_requests'] + 2
    return compare(reference(ref, cfg, inp, k, dtype), reference(ref, cfg, inp, k))
