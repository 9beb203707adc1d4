"""Faults planted under the timed path, to show that the check catches them.

``HalfBatch`` renders half of the views and leaves the rest out (a fit step
then takes the mean over the views it has); ``Altered`` changes one view's
answer where it is produced; ``VertexGrad`` halves the gradient that
reaches the vertices, and so the offsets, and nothing else (the forward is
untouched); ``unchanged`` makes every optimizer step leave the state as it
was.  The harness's tests drive a run over each and see
``correct`` come out false; ``calibrate.py`` reads the check's numbers of
each on the card at the cell's size.  A cell on one card has no exchange
between cards to leave out.
"""
from __future__ import annotations

import contextlib

import torch


class _Wrapped:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, key):
        return getattr(self.inner, key)


class HalfBatch(_Wrapped):
    def render(self, vertices, faces, textures, eyes) -> dict:
        h = vertices.shape[0] // 2
        return self.inner.render(vertices[:h], faces[:h], textures[:h], eyes[:h])


class Altered(_Wrapped):
    def render(self, vertices, faces, textures, eyes) -> dict:
        out = dict(self.inner.render(vertices, faces, textures, eyes))
        rgb = out['rgb']
        H = rgb.shape[-1]
        patch = torch.zeros_like(rgb)
        patch[0, :, H // 2 - 16:H // 2 + 16, H // 2 - 16:H // 2 + 16] = 0.05
        out['rgb'] = rgb + patch
        return out


class VertexGrad(_Wrapped):
    def render(self, vertices, faces, textures, eyes) -> dict:
        v = vertices.detach()
        return self.inner.render(v + 0.5 * (vertices - v), faces, textures, eyes)


@contextlib.contextmanager
def unchanged():
    """Every ``torch.optim.Adam`` step leaves its parameters and state as
    they were."""
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


PROGRAM_FAULTS = {'half': HalfBatch, 'altered': Altered, 'vertex_grad': VertexGrad}


def faulty(make, name: str):
    """``make(cfg, device)`` with the program wrapped in fault ``name``."""
    def build(cfg, device):
        return PROGRAM_FAULTS[name](make(cfg, device))
    return build
