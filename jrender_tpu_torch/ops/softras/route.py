"""Which SoftRas route a call takes: 'dir', 'pxg' or 'binned'.

Counterpart of ``jrender_tpu/ops/softras/api.py`` ``_pallas_route``
(:49-75), which chooses among the JAX package's TPU layouts by
``JR_LAYOUT`` (default ``'pxt'``) and ``JR_DIR_MAX``.  The port reads both
variables at call time (the JAX package reads ``JR_LAYOUT`` once, at
import, ``pallas_impl.py:51``):

  ``JR_LAYOUT``    size divisible by 8                       other sizes
  ``'pxt'``        'dir' where F <= ``JR_DIR_MAX``, else      'binned'
                   'binned' (the JAX package's ``pxt``)
  ``'pxg'``        'pxg' (never 'dir': the JAX package tests   'binned'
                   for 'dir' under ``'pxt'`` only)
  ``'px_f'``,      NotImplementedError: those layouts' kernels are not
  ``'f_px'``       ported yet (ROADMAP.md queue B items 6-7)
  anything else    ValueError

At sizes not divisible by 8 the JAX package takes its oracle or ``f_px``;
the port's binned kernels serve any size (ROADMAP.md section C).  The
error cases never fall back to another route.
"""
from __future__ import annotations

import contextlib
import os

from .dir_impl import dir_max_faces, dir_tile
from .params import SoftRasParams

LAYOUTS = ('pxt', 'pxg', 'px_f', 'f_px')


def layout() -> str:
    """``JR_LAYOUT``, default 'pxt'."""
    return os.environ.get('JR_LAYOUT', 'pxt')


@contextlib.contextmanager
def with_layout(name: str):
    """``JR_LAYOUT`` set to ``name`` inside the block, restored after it."""
    saved = os.environ.get('JR_LAYOUT')
    os.environ['JR_LAYOUT'] = name
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop('JR_LAYOUT', None)
        else:
            os.environ['JR_LAYOUT'] = saved


def route(p: SoftRasParams, F: int) -> str:
    """'dir', 'pxg' or 'binned': the route of a call with F faces."""
    name = layout()
    if name in ('px_f', 'f_px'):
        raise NotImplementedError(
            f'JR_LAYOUT={name}: the {name} kernels are not ported yet '
            f'(ROADMAP.md queue B items 6-7); unset JR_LAYOUT or use pxt or pxg')
    if name not in LAYOUTS:
        raise ValueError(f'JR_LAYOUT must be one of {LAYOUTS}, got {name!r}')
    if not dir_tile(p.image_size):
        return 'binned'
    if name == 'pxg':
        return 'pxg'
    return 'dir' if F <= dir_max_faces() else 'binned'
