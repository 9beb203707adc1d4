"""Hopper probes: the counterparts of the JAX package's TPU timing probes.

The repository's TPU probes in ``tools/`` each hold a ``pallas_call`` that
no entry point of the package runs; they ask what a step of a kernel costs
on the chip.  Here each is a hand-written CUDA kernel with its wrapper and
plain version, run by a tool of its own and by ``chip_smoke.py`` phase 18:

  ``micro``    T1, ``tools/exp_micro.py``: a px_f-style grid step (a fixed
               cost, pair arithmetic, per-face work, row slices, small
               products); ``tools/exp_torch_micro.py``
  ``bwd_dma``  T2, ``tools/exp_bwd_dma.py``: a backward work item's
               staging (face block in, gradient block out, px rows by 16
               copies or one ranged copy, a transpose, 0/1 selection
               products); ``tools/exp_torch_bwd_dma.py``

T3, ``tools/profile_bwd.py``, times the px_f backward's kernel (K6) by
stage; its counterpart ``tools/profile_torch_bwd.py`` runs the port's K6
(``ops/softras/pxf_impl.py``) and needs no kernel of its own.

No entry point of the package calls a probe: their launches on the main
path are 0.
"""
from . import bwd_dma, micro

__all__ = ['bwd_dma', 'micro']
