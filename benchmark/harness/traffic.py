"""The one traffic generator, and the loops that drive a mix.

A mix is a data file, ``traffic/<name>.json``, of one of two kinds; both
are closed loops with one caller:

  ``fit``     one fitting step of ``views`` views a call: ``render_mesh`` of
              the mesh with per-vertex offsets added, an MSE loss on rgb and
              alpha against targets, backward into the offsets and the
              textures, Adam.  The views lie 360/``views`` degrees apart, the
              whole set turned each step by an angle drawn from the seed.
              The offsets are ``offset_scale * tanh(raw)``, Adam moving
              ``raw``: bounded as demo 2's sigmoid-bounded displacement is,
              so the mesh cannot crumple and every step of a window of any
              length does the same work.
  ``frames``  one request of ``views`` views a call, with no gradient,
              ended by ``torch.cuda.synchronize()``: consecutive frames of a
              turntable at ``degrees_per_frame``, each request going on
              where the last ended.

The seed fixes the textures, the targets, the initial offsets and a phase
added to every azimuth; every seed gets the same sizes.  Everything is made
on the card in a few calls of a ``torch.Generator`` there; the eyes of each
step or request come from a table made at set-up, so a call reads nothing
from the host.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import torch

from benchmark.reference import scene

TABLE = 16384            # steps or requests whose eyes the table holds


def sync(device):
    """Wait for the card (nothing to wait for on the CPU, where the
    harness's tests drive the loops)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


@dataclasses.dataclass
class Inputs:
    template: torch.Tensor       # [1,V,3]
    faces: torch.Tensor          # [1,F,3] int64
    textures: torch.Tensor       # [1,F,...] the textures at the start
    raw: torch.Tensor            # [1,V,3] the offsets' parameter at the start (fit)
    offset_scale: float          # offsets = offset_scale * tanh(raw)
    targets: dict                # name -> [N,...] (fit)
    eyes: torch.Tensor           # [TABLE, N, 3]
    views: int

    def batch(self, x):
        return x.expand(self.views, *([-1] * (x.dim() - 1)))

    def vertices(self, raw):
        """The mesh's vertices [1,V,3] at the offsets' parameter ``raw``."""
        return self.template + self.offset_scale * torch.tanh(raw)


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> Inputs:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sph = cfg['mesh']['uv_sphere']
    v, f = scene.uv_sphere(sph['rings'], sph['segs'], sph['radius'], device=device)
    F, N = f.shape[0], mix['views']
    textures = torch.rand((1, F, *cfg['textures']), generator=g, device=device)
    raw = torch.rand((1, v.shape[0], 3), generator=g, device=device) - 0.5
    phase = torch.rand((), generator=g, device=device, dtype=torch.float64) * 360
    k = torch.arange(TABLE, device=device, dtype=torch.float64)[:, None]
    j = torch.arange(N, device=device, dtype=torch.float64)[None, :]
    if mix['kind'] == 'fit':
        turn = torch.rand((TABLE, 1), generator=g, device=device, dtype=torch.float64) * 360
        az = phase + turn + 360.0 * j / N
    else:
        az = phase + mix['degrees_per_frame'] * (k * N + j)
    cam = cfg['camera']
    eyes = scene.eyes_from_angles(cam['distance'], cam['elevation'],
                                  torch.remainder(az, 360.0)).to(torch.float32)
    targets = make_targets(cfg, N, g, device) if mix['kind'] == 'fit' else {}
    return Inputs(template=v[None], faces=f[None], textures=textures, raw=raw,
                  offset_scale=mix.get('offset_scale', 0.0), targets=targets,
                  eyes=eyes.contiguous(), views=N)


def make_targets(cfg: dict, N: int, g, device) -> dict:
    """Per view: the sphere's silhouette (a disc, the same from every
    azimuth) as alpha, and inside it a smooth colour field of its own as
    rgb, black outside."""
    H = cfg['image_size']
    cam = cfg['camera']
    c = (2 * torch.arange(H, device=device, dtype=torch.float32) + 1 - H) / H
    ys, xs = -c[:, None], c[None, :]
    radius = math.tan(math.asin(cfg['mesh']['uv_sphere']['radius'] / cam['distance'])) \
        / math.tan(math.radians(cam['viewing_angle']))
    disc = ((xs * xs + ys * ys) <= radius * radius).float()
    freq = torch.rand((N, 3, 2, 1, 1), generator=g, device=device) * 4 + 1
    ph = torch.rand((N, 3, 1, 1), generator=g, device=device) * 2 * math.pi
    rgb = (0.5 + 0.4 * torch.sin(2 * math.pi * (freq[:, :, 0] * xs + freq[:, :, 1] * ys) + ph)) \
        * disc
    return {'rgb': rgb.contiguous(), 'alpha': disc.expand(N, H, H).contiguous()}


def image_loss(out: dict, targets: dict):
    """The mean squared error of each target's output, summed; over the
    views the outputs hold (all of them, unless a program left some out)."""
    return sum(((out[k] - t[:out[k].shape[0]]) ** 2).mean() for k, t in targets.items())


class FitStep:
    """The training step: the offsets and textures, their Adam, and one
    call = one step of the mix on the table's next eyes."""

    def __init__(self, prog, inp: Inputs, mix: dict):
        self.prog, self.inp = prog, inp
        self.raw = inp.raw.clone().requires_grad_()
        self.textures = inp.textures.clone().requires_grad_()
        o, t = mix['optimizer']['offsets'], mix['optimizer']['textures']
        self.betas = (tuple(o['betas']), tuple(t['betas']))
        self.opt = torch.optim.Adam([
            {'params': [self.raw], 'lr': o['lr'], 'betas': self.betas[0]},
            {'params': [self.textures], 'lr': t['lr'], 'betas': self.betas[1]}])
        self.k = 0

    def leaves(self):
        return [self.raw, self.textures]

    def __call__(self):
        inp = self.inp
        self.opt.zero_grad(set_to_none=True)
        out = self.prog.render(inp.batch(inp.vertices(self.raw)), inp.batch(inp.faces),
                               inp.batch(self.textures), inp.eyes[self.k % TABLE])
        loss = image_loss(out, inp.targets)
        loss.backward()
        self.opt.step()
        self.k += 1
        return loss, out

    def first_gradients(self):
        """The gradients of the first step as the optimizer got them,
        worked out from its state after that step: exp_avg / (1 - beta1);
        none where the optimizer holds no state for a leaf."""
        return [self.opt.state[x]['exp_avg'] / (1 - b[0]) if 'exp_avg' in self.opt.state[x]
                else torch.zeros_like(x) for x, b in zip(self.leaves(), self.betas)]


class Frames:
    """One call = one request of the mix: the next ``views`` frames, ended
    by a synchronize.  ``enqueue`` is the request without that synchronize:
    what the host does before it waits for the card."""

    def __init__(self, prog, inp: Inputs):
        self.prog, self.inp = prog, inp
        self.k = 0

    def enqueue(self):
        inp = self.inp
        with torch.no_grad():
            out = self.prog.render(inp.batch(inp.template), inp.batch(inp.faces),
                                   inp.batch(inp.textures), inp.eyes[self.k % TABLE])
        self.k += 1
        return out

    def __call__(self):
        out = self.enqueue()
        sync(self.inp.template.device)
        return out


# --------------------------------------------------------------------------
# the loops
# --------------------------------------------------------------------------

def fit_setup(step: FitStep, mix: dict) -> dict:
    """The first ``checked_steps`` steps, through the window's own call:
    what the reference is compared with (each step's loss, the first
    gradients, the first step's images on the host, the change of the
    leaves over the steps)."""
    start = [x.detach().clone() for x in step.leaves()]
    losses, record, times = [], {}, []
    for i in range(mix['checked_steps']):
        t = time.perf_counter()
        loss, out = step()
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t)
        if i == 0:
            record['grads'] = [g.clone() for g in step.first_gradients()]
            record['images'] = {k: v.detach().cpu() for k, v in out.items()}
    record['losses'] = losses
    record['step_s'] = times
    record['change'] = [(x.detach() - s) for x, s in zip(step.leaves(), start)]
    sync(step.inp.template.device)
    return record


def fit_window(step: FitStep, seconds: float) -> dict:
    """Steps back to back for ``seconds``, no host read; the window ends at
    the synchronize after the last step."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step()
        n += 1
    sync(step.inp.template.device)
    t = time.perf_counter() - t0
    return {'steps': n, 'window_s': t, 'step_ms': t / n * 1e3}


def frames_window(frames: Frames, seconds: float, seed: int) -> dict:
    """Requests back to back for ``seconds``; each request's latency from
    its start to its synchronize.  One request's outputs, drawn from the
    seed by reservoir sampling, are kept for the check."""
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
    return {'requests': len(lat), 'window_s': t, 'latencies': lat,
            'p95_ms': lat_sorted[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)] * 1e3,
            'frames_per_s': frames.inp.views * len(lat) / t, 'kept': kept}


def host_times(call, n: int, device) -> list:
    """Host seconds of ``n`` calls, each started on an idle card and timed
    to its return; ``call`` is a fit step or a request's ``enqueue``, which
    end in no synchronise of the harness's (the program's own host reads
    inside them stay)."""
    out = []
    for _ in range(n):
        sync(device)
        t = time.perf_counter()
        call()
        out.append(time.perf_counter() - t)
    sync(device)
    return out


def traced(call, n: int, path: str):
    """``n`` calls under torch.profiler, each in a ``bench.step`` range,
    after two calls that the profiler may see only in part; the trace is
    written to ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        for _ in range(n):
            with record_function('bench.step'):
                call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
