"""The traffic kind ``fit``: one fitting step of ``views`` views a call, a
closed loop with one caller.

A step is ``render_mesh`` of the mesh with per-vertex offsets added, an MSE
loss on rgb and alpha against targets, backward into the offsets and the
textures, and Adam.  The views lie 360/``views`` degrees apart, the whole
set turned each step by an angle drawn from the seed.  The offsets are
``offset_scale * tanh(raw)``, Adam moving ``raw``: bounded as demo 2's
sigmoid-bounded displacement is, so the mesh cannot crumple and every step
of a window of any length does the same work.  The seed fixes the inputs
of ``harness/mesh.py``, then each step's turn, then the targets.

Set-up runs the first ``checked_steps`` steps through the window's own
call on the window's object; the check has the reference follow the same
steps from the same start:

  ``loss``    each step's loss, the largest relative gap;
  ``grad``    the first step's gradient norms as the optimizer got them,
              the worst leaf's gap (``check.norm_gap``);
  ``change``  the norms of the leaves' change over the steps, the worst
              leaf's gap; a leaf whose reference gradient is under a
              thousandth of the median leaf's is left out (it moves by
              round-off alone);
  ``image``   the first step's images (``check.pixel_share``).
"""
from __future__ import annotations

import math
import time

import torch

from benchmark.harness import check, faults, mesh
from benchmark.harness.traffic import sync
from benchmark.reference import scene

HOST_COUNT = 'host_steps'        # the mix's count of steps that host_ms times
TRACED_COUNT = 'traced_steps'    # and of steps that the profiler sees

REFERENCE = ('render', 'census', 'least_work')    # what reference/<config>.py gives

FAULTS = {
    'half': faults.wrapping(faults.HalfBatch),
    'altered': faults.wrapping(faults.Altered),
    'vertex_grad': faults.wrapping(faults.VertexGrad),
    'unchanged': faults.state_unchanged,
}


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> mesh.Inputs:
    def azimuths(phase, k, j, g):
        turn = torch.rand((mesh.TABLE, 1), generator=g, device=device, dtype=torch.float64) * 360
        return phase + turn + 360.0 * j / mix['views']
    return mesh.make_inputs(cfg, mix, seed, device, azimuths, make_targets)


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


class Call:
    """The training step: the offsets and textures, their Adam, and one
    call = one step of the mix on the table's next eyes.  A step ends in
    no synchronize, so it is its own ``enqueue``; ``kept`` is set-up's
    record, which the check compares."""

    def __init__(self, prog, inp: mesh.Inputs, mix: dict):
        self.prog, self.inp = prog, inp
        self.raw = inp.raw.clone().requires_grad_()
        self.textures = inp.textures.clone().requires_grad_()
        o, t = mix['optimizer']['offsets'], mix['optimizer']['textures']
        self.betas = (tuple(o['betas']), tuple(t['betas']))
        self.opt = torch.optim.Adam([
            {'params': [self.raw], 'lr': o['lr'], 'betas': self.betas[0]},
            {'params': [self.textures], 'lr': t['lr'], 'betas': self.betas[1]}])
        self.k = 0
        self.kept = None
        self.geometry = None     # the vertices and textures as the traced window starts

    def leaves(self):
        return [self.raw, self.textures]

    def __call__(self):
        inp = self.inp
        self.opt.zero_grad(set_to_none=True)
        out = self.prog.render(inp.batch(inp.vertices(self.raw)), inp.batch(inp.faces),
                               inp.batch(self.textures), inp.eyes[self.k % mesh.TABLE])
        loss = image_loss(out, inp.targets)
        loss.backward()
        self.opt.step()
        self.k += 1
        return loss, out

    enqueue = __call__

    def first_gradients(self):
        """The gradients of the first step as the optimizer got them,
        worked out from its state after that step: exp_avg / (1 - beta1);
        none where the optimizer holds no state for a leaf."""
        return [self.opt.state[x]['exp_avg'] / (1 - b[0]) if 'exp_avg' in self.opt.state[x]
                else torch.zeros_like(x) for x, b in zip(self.leaves(), self.betas)]


def setup(step: Call, mix: dict) -> str:
    """The first ``checked_steps`` steps, through the window's own call;
    their record (each step's loss, the first gradients, the first step's
    images on the host, the change of the leaves over the steps) is kept
    for the check.  Returns each step's seconds, for the set-up line."""
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
    step.kept = record
    return f' (steps {", ".join(f"{t:.3f}" for t in times)})'


def window(step: Call, seconds: float, seed: int) -> tuple[int, dict]:
    """Steps back to back for ``seconds``, no host read; the window ends at
    the synchronize after the last step.  (steps, {step_ms})."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step()
        n += 1
    sync(step.inp.template.device)
    t = time.perf_counter() - t0
    return n, {'step_ms': t / n * 1e3}


def traced_call(step: Call, n: int, seed: int) -> Call:
    """The step itself, holding the vertices and textures as the traced
    window starts, whose work the readers count."""
    step.geometry = (step.inp.vertices(step.raw.detach()), step.textures.detach())
    return step


def layer_context(cell, prog, ref, inp, step: Call, tr, host, n, first) -> dict:
    return mesh.layer_context(cell, prog, ref, inp, step.geometry, tr, host, n, first, fit=True)


def sample(step: Call, mix: dict):
    """What a run keeps for its check, made without a window: set-up's."""
    setup(step, mix)
    return step.kept


def reference(ref, cfg: dict, inp: mesh.Inputs, mix: dict, dtype=torch.float32) -> dict:
    """The reference's first steps from the program's start, in ``dtype``:
    the same record as ``setup`` makes of the program."""
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
                         cast(inp.eyes[k % mesh.TABLE]))
        loss = image_loss(out, targets)
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


def compare(got: dict, want: dict, readings: bool = False) -> dict:
    """The check's numbers of record ``got`` against the reference's
    ``want``; with ``readings``, also each leaf's norms (``leaves``)."""
    out = {
        'loss': max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got['losses'], want['losses'])),
        'grad': check.norm_gap(got['grads'], want['grads']),
        'change': check.norm_gap(got['change'], want['change'], want['grads']),
        'image': check.pixel_share(got['images'], want['images']),
    }
    if readings:
        out['leaves'] = leaf_norms(got, want)
    return out


def leaf_norms(got: dict, want: dict) -> dict:
    """Per leaf (offsets, textures): [norm of the compared side, norm of
    the reference] of the first gradients and of the change."""
    def n(x):
        return float(torch.linalg.vector_norm(x.double()))
    return {k: [[n(a), n(b)] for a, b in zip(got[k], want[k])] for k in ('grads', 'change')}


def numbers(cfg: dict, mix: dict, ref, inp: mesh.Inputs, kept: dict,
            readings: bool = False) -> dict:
    """The program's check numbers: set-up's record against the reference."""
    return compare(kept, reference(ref, cfg, inp, mix), readings)


def control_numbers(cfg: dict, mix: dict, ref, inp: mesh.Inputs, dtype,
                    readings: bool = False) -> dict:
    """The control's: the reference in ``dtype``, in the program's place."""
    return compare(reference(ref, cfg, inp, mix, dtype), reference(ref, cfg, inp, mix), readings)
