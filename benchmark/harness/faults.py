"""Faults planted under the timed path of the mesh kinds, to show that the
check catches them.

``HalfBatch`` renders half of the views and leaves the rest out (a fit step
then takes the mean over the views it has); ``Altered`` changes one view's
answer where it is produced; ``VertexGrad`` halves the gradient that
reaches the vertices, and so the offsets, and nothing else (the forward is
untouched); ``unchanged`` makes every optimizer step leave the state as it
was.  A kind lists the faults it can have by name in its ``FAULTS``: each
``plant(prog)`` a context manager that yields the program to drive in
place of ``prog``.  The harness's tests drive a run over each and see
``correct`` come out false; ``calibrate.py`` reads the check's numbers of
each on the card at the cell's size.  A cell on one card has no exchange
between cards to leave out.
"""
from __future__ import annotations

import contextlib

import torch


class Wrapped:
    """A program wrapped by a fault; what the fault does not replace is the
    inner program's."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, key):
        return getattr(self.inner, key)


class HalfBatch(Wrapped):
    def render(self, vertices, faces, textures, eyes) -> dict:
        h = vertices.shape[0] // 2
        return self.inner.render(vertices[:h], faces[:h], textures[:h], eyes[:h])


class Altered(Wrapped):
    def render(self, vertices, faces, textures, eyes) -> dict:
        out = dict(self.inner.render(vertices, faces, textures, eyes))
        rgb = out['rgb']
        H = rgb.shape[-1]
        patch = torch.zeros_like(rgb)
        patch[0, :, H // 2 - 16:H // 2 + 16, H // 2 - 16:H // 2 + 16] = 0.05
        out['rgb'] = rgb + patch
        return out


class VertexGrad(Wrapped):
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


def wrapping(cls):
    """The fault that wraps the program in ``cls``."""
    @contextlib.contextmanager
    def plant(prog):
        yield cls(prog)
    return plant


@contextlib.contextmanager
def state_unchanged(prog):
    """The fault ``unchanged`` on the program ``prog``, which it leaves as
    it is.  It freezes every ``torch.optim.Adam`` of the process, so a kind
    lists it only where its reference steps an optimizer of its own (the
    mesh references' ``scene.Adam``); a kind whose reference steps a
    ``torch.optim.Adam`` freezes the program's own instance instead."""
    with unchanged():
        yield prog
