"""Helpers for holding a SoftRas gradient against another computation of it.

``chip_smoke.py`` and the tests compare a backward with its plain version
or with the JAX package's; these are the parts of that comparison they
share.  They take torch tensors or numpy arrays.

Tolerance: atol = GRAD_TOL * max|want| and rtol = GRAD_TOL, the JAX
suite's own (tests/test_softras_pallas.py:126-128): a gradient sums
thousands of pixels in another order on each side, of terms amplified by
1/sigma and 1/gamma.

Texel ties: a soft pixel outside a face has its clipped barycentric point
on an edge, where wc0 + wc1 = 1 puts the texel selector exactly on its
diagonal, and the last bit decides between texel i and texel T-1-i.  Two
arithmetics do not round alike there.  ``tie_symmetric`` makes surface
textures equal on the two sides of the tie, so that the face gradient
does not depend on it, and ``fold_ties`` sums a texture gradient over
each tie pair.
"""
from __future__ import annotations

import numpy as np
import torch

GRAD_TOL = 2e-3


def _tensor(x):
    # a copy: numpy arrays may be read-only or have negative strides
    return torch.tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _flip_texels(x):
    return x.flip(2) if torch.is_tensor(x) else x[:, :, ::-1]


def tie_symmetric(textures):
    """Surface textures [B,F,T,3] with texel i equal to texel T-1-i."""
    return (textures + _flip_texels(textures)) / 2


def fold_ties(grad_textures):
    """Surface texture gradients [B,F,T,3] with each tie pair (i, T-1-i)
    summed."""
    return grad_textures + _flip_texels(grad_textures)


def grad_beyond(got, want, faces=None):
    """(share of entries of ``got`` beyond atol = GRAD_TOL * max|want| and
    rtol = GRAD_TOL of ``want``, the max abs difference over max|want|).
    ``faces``, a boolean mask [B,F], restricts both to those faces' rows;
    the scale stays that of the whole gradient.  Raises on a shape
    mismatch or a non-finite entry of ``got``."""
    got, want = _tensor(got), _tensor(want)
    if got.shape != want.shape:
        raise AssertionError(f'gradient of shape {tuple(got.shape)}, expected '
                             f'{tuple(want.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite gradient')
    got, want = got.double(), want.double()
    scale = max(want.abs().max().item(), 1e-6)
    d = (got - want).abs()
    bad = d > GRAD_TOL * scale + GRAD_TOL * want.abs()
    if faces is not None:
        faces = torch.as_tensor(faces, device=got.device)
        d, bad = d[faces], bad[faces]
    if d.numel() == 0:
        return 0.0, 0.0
    return bad.double().mean().item(), d.max().item() / scale
