"""The traffic kind ``nerf_fit``: NeRF training steps, a closed loop with
one caller; the harness's own test of a kind that is not a mesh adds it.

A step trains the configuration's coarse and fine MLPs on ``N_rand`` rays
of one of ``images`` images (the images in turn): the rays' pixels, their
strata and their importance samples come from a table drawn from the seed
(``draws`` of ``make_train_step``), as do the images, the poses on a
sphere about the scene, and the seed of the initial weights.  Set-up runs
the first ``checked_steps`` steps through the window's own call; the check
has the reference follow them from the same start: each step's ``loss``
(largest relative gap), the first step's gradients as Adam got them
(``grad``) and the weights' change over the steps (``change``), each the
worst leaf's gap of norms (``check.norm_gap``).
"""
from __future__ import annotations

import math
import time

import torch

from benchmark.harness import check, faults
from benchmark.harness.traffic import sync

HOST_COUNT = 'host_steps'
TRACED_COUNT = 'traced_steps'
TABLE = 64               # steps whose draws the table holds
REFERENCE = ('fit',)     # what reference/<config>.py gives


class Inputs:
    def __init__(self, images, poses, draws: dict, weight_seed: int):
        self.images, self.poses, self.draws, self.weight_seed = images, poses, draws, weight_seed

    def step_draws(self, k: int) -> dict:
        return {n: v[k % TABLE] for n, v in self.draws.items()}


def poses_on_sphere(theta, elevation: float, radius: float):
    """Camera-to-world [P,3,4] at azimuths ``theta`` (radians), looking at
    the origin: the Blender scenes' ``pose_spherical``."""
    P = theta.shape[0]
    phi = math.radians(elevation)
    c, s = torch.cos(theta), torch.sin(theta)
    eye = torch.eye(4, dtype=theta.dtype, device=theta.device).repeat(P, 1, 1)
    rot_theta = eye.clone()
    rot_theta[:, 0, 0], rot_theta[:, 0, 2], rot_theta[:, 2, 0], rot_theta[:, 2, 2] = c, -s, s, c
    rot_phi = eye[0].clone()
    rot_phi[1, 1], rot_phi[1, 2], rot_phi[2, 1], rot_phi[2, 2] = \
        math.cos(phi), -math.sin(phi), math.sin(phi), math.cos(phi)
    trans = eye[0].clone()
    trans[2, 3] = radius
    swap = torch.tensor([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                        dtype=theta.dtype, device=theta.device)
    return (swap @ rot_theta @ rot_phi @ trans)[:, :3, :4].float().contiguous()


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> Inputs:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, H, P = cfg['nerf']['N_rand'], cfg['image_size'], mix['images']
    images = torch.rand((P, H, H, 3), generator=g, device=device)
    theta = torch.rand((P,), generator=g, device=device, dtype=torch.float64) * 2 * math.pi
    draws = {
        'fy': torch.randint(0, H, (TABLE, n), generator=g, device=device),
        'fx': torch.randint(0, H, (TABLE, n), generator=g, device=device),
        't_rand': torch.rand((TABLE, n, cfg['nerf']['N_samples']), generator=g, device=device),
        'u': torch.rand((TABLE, n, cfg['nerf']['N_importance']), generator=g, device=device),
    }
    weight_seed = int(torch.randint(0, 2 ** 62, (), generator=g, device=device))
    return Inputs(images, poses_on_sphere(theta, cfg['elevation'], cfg['radius']), draws,
                  weight_seed)


class Call:
    """One call = one train step on the table's next draws; it ends in no
    synchronize, so it is its own ``enqueue``; ``kept`` is set-up's record."""

    def __init__(self, prog, inp: Inputs, mix: dict):
        self.nets, self.opt, self.step = prog.fresh(inp.weight_seed)
        self.inp, self.k, self.kept = inp, 0, None

    def leaves(self):
        return list(self.nets.parameters())

    def __call__(self):
        inp = self.inp
        p = self.k % inp.images.shape[0]
        loss, _ = self.step(self.nets, inp.images[p], inp.poses[p], self.k,
                            draws=inp.step_draws(self.k))
        self.k += 1
        return loss

    enqueue = __call__

    def first_gradients(self):
        """The first step's gradients as Adam got them, from its state:
        exp_avg / (1 - beta1)."""
        adam = self.opt.adam
        beta1 = adam.param_groups[0]['betas'][0]
        return [adam.state[x]['exp_avg'] / (1 - beta1) if 'exp_avg' in adam.state[x]
                else torch.zeros_like(x) for x in self.leaves()]


class HalfRays(faults.Wrapped):
    """The fault ``half``: each step trains on half of its rays, the mean
    taken over those."""

    def fresh(self, weight_seed: int):
        nets, opt, step = self.inner.fresh(weight_seed)

        def half(nets, image, pose, k, draws):
            return step(nets, image, pose, k,
                        draws={n: v[:v.shape[0] // 2] for n, v in draws.items()})
        return nets, opt, half


class FrozenOptimizer(faults.Wrapped):
    """The fault ``unchanged``: the program's own optimizer leaves the
    weights and its state as they were.  Only that instance is frozen, not
    ``torch.optim.Adam`` as ``faults.state_unchanged`` freezes it, since
    this reference steps a ``torch.optim.Adam`` too."""

    def fresh(self, weight_seed: int):
        nets, opt, step = self.inner.fresh(weight_seed)
        opt.adam.step = lambda closure=None: None
        return nets, opt, step


FAULTS = {'half': faults.wrapping(HalfRays), 'unchanged': faults.wrapping(FrozenOptimizer)}


def setup(step: Call, mix: dict) -> str:
    start = [x.detach().clone() for x in step.leaves()]
    record, times = {'losses': []}, []
    for i in range(mix['checked_steps']):
        t = time.perf_counter()
        record['losses'].append(float(step()))
        times.append(time.perf_counter() - t)
        if i == 0:
            record['grads'] = [g.clone() for g in step.first_gradients()]
    record['change'] = [x.detach() - s for x, s in zip(step.leaves(), start)]
    step.kept = record
    return f' (steps {", ".join(f"{t:.3f}" for t in times)})'


def window(step: Call, seconds: float, seed: int) -> tuple[int, dict]:
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step()
        n += 1
    sync(step.inp.images.device)
    return n, {'step_ms': (time.perf_counter() - t0) / n * 1e3}


def traced_call(step: Call, n: int, seed: int) -> Call:
    return step


def layer_context(cell, prog, ref, inp, step: Call, tr, host, n, first) -> dict:
    return {'steps': n, 'host_s': host, 'window_s': tr.window_s, 'busy_s': tr.busy_s,
            'activities': tr.activities, 'trace': tr}


def sample(step: Call, mix: dict):
    setup(step, mix)
    return step.kept


def compare(got: dict, want: dict, readings: bool = False) -> dict:
    return {
        'loss': max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got['losses'], want['losses'])),
        'grad': check.norm_gap(got['grads'], want['grads']),
        'change': check.norm_gap(got['change'], want['change'], want['grads']),
    }


def numbers(cfg: dict, mix: dict, ref, inp: Inputs, kept: dict, readings: bool = False) -> dict:
    return compare(kept, ref.fit(cfg, inp, mix['checked_steps']), readings)


def control_numbers(cfg: dict, mix: dict, ref, inp: Inputs, dtype,
                    readings: bool = False) -> dict:
    return compare(ref.fit(cfg, inp, mix['checked_steps'], dtype),
                   ref.fit(cfg, inp, mix['checked_steps']), readings)
