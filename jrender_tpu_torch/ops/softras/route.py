"""Which SoftRas route a call takes: 'dir', 'pxg', 'px_f', 'f_px' or 'binned'.

Counterpart of ``jrender_tpu/ops/softras/api.py`` ``_pallas_route``
(:49-75), which chooses among the JAX package's TPU layouts by
``JR_LAYOUT`` (default ``'pxt'``), ``JR_DIR_MAX`` and whether a gradient
follows (``for_grad``).  The port reads both variables at call time (the
JAX package reads ``JR_LAYOUT`` once, at import, ``pallas_impl.py:51``).
*Binding* below means ``need_grad`` with ``grad_mode='topk'`` and K < F:

  ``JR_LAYOUT``  size                                 route
  ``'pxt'``      divisible by 8                       'dir' where F <= ``JR_DIR_MAX``,
                                                      else 'binned' (the JAX ``pxt``)
  ``'pxg'``      divisible by 8                       'pxg'
  ``'px_f'``     divisible by 8                       'px_f' (``pxf_impl.tile_for``)
  ``'f_px'``     16 x min(128, is) tiles divide it    'binned' when binding (the JAX
                 (``fpx_impl.runs``)                  package takes its oracle), else
                                                      'f_px'
  any layout     other sizes                          'binned'
  anything else                                       ValueError

'dir' is taken under ``'pxt'`` only, as in the JAX package.  Where the JAX
package falls back to its oracle (``'jax'``), or its ``f_px`` forward
asserts (sizes that 16 x min(128, is) tiles do not divide), the port's
binned kernels serve the call: they give the oracle's top-K gradient at
any size (ROADMAP.md section C).  The f_px backward is untruncated, so the
route never gives it a call where the truncation binds.
"""
from __future__ import annotations

import contextlib
import os

from . import fpx_impl, pxf_impl, torch_impl
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


def route(p: SoftRasParams, F: int, need_grad: bool) -> str:
    """'dir', 'pxg', 'px_f', 'f_px' or 'binned': the route of a call with F
    faces; ``need_grad`` says whether a backward may follow."""
    name = layout()
    if name not in LAYOUTS:
        raise ValueError(f'JR_LAYOUT must be one of {LAYOUTS}, got {name!r}')
    if name == 'f_px':
        binding = need_grad and torch_impl.use_threshold(p, F)
        return 'f_px' if fpx_impl.runs(p.image_size) and not binding else 'binned'
    if name == 'px_f':
        return 'px_f' if pxf_impl.tile_for(p.image_size) else 'binned'
    if not dir_tile(p.image_size):
        return 'binned'
    if name == 'pxg':
        return 'pxg'
    return 'dir' if F <= dir_max_faces() else 'binned'
