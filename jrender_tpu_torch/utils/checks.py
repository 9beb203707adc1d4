"""Helpers for holding a gradient, or a z-buffer, against another
computation of it.

``chip_smoke.py`` and the tests compare a backward with its plain version
or with the JAX package's; these are the parts of that comparison they
share.  They take torch tensors or numpy arrays.  The SoftRas helpers
come first, the N3MR ones (``n3mr_special_faces``, ``n3mr_maps_beyond``,
``scaled_err``) last.

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


def tie_soup():
    """Four faces [1,4,9] (numpy) whose hard z-buffer ties are exact in any
    float32 arithmetic: right triangles with power-of-two legs on a dyadic
    grid, so barycentrics and depths carry no rounding.  Faces 0 to 2 lie on
    z = 4 inside face 1 (y <= x), face 3 on z = 2.  The dir route's Morton
    order walks face 2, then 1, then 0: a tie must go to the lowest id all
    the same (0 over 1 over 2), and face 3 wins by depth."""
    return np.array([[[0.25, 0.0, 4, 0.75, 0.0, 4, 0.75, 0.5, 4],
                      [-1.0, -1.0, 4, 1.0, -1.0, 4, 1.0, 1.0, 4],
                      [-0.75, -0.875, 4, -0.25, -0.875, 4, -0.25, -0.375, 4],
                      [0.25, -0.75, 2, 0.75, -0.75, 2, 0.75, -0.25, 2]]], np.float32)


N3MR_FLIP_FRAC = 1e-3     # z-buffer: share of pixels whose winner may differ
N3MR_DEPTH_RTOL = 1e-6    # ... and how close the two winners' depths must be
N3MR_SUM_TOL = 2e-5       # N3MR gradients, of max|want| (tests/test_n3mr.py:196-198)


def n3mr_special_faces(face):
    """A copy of face [B,F,9] whose face 0 covers most of the screen (a big
    face of the binning), whose face 1 has zero area and whose face 2 has a
    NaN corner; the last two must win no pixel."""
    face = face.clone()
    face[:, 0] = face.new_tensor([-2.5, -2.5, 3.5, 2.5, -2.5, 3.6, 0.0, 1.5, 3.7])
    face[:, 1, 3:6] = face[:, 1, 0:3]
    face[:, 1, 6:9] = face[:, 1, 0:3]
    face[:, 2, 4] = float('nan')
    return face


def n3mr_maps_beyond(got, want):
    """Hold one z-buffer result against another: each a tuple (face_index,
    weight, depth, face_inv, zcorn) and optionally rgb, of equal shapes.

    Winners must agree except at near-tie pixels: where two faces' depths
    differ in the last bits, either may win on either side.  At most
    N3MR_FLIP_FRAC of the pixels may flip, and a flipped pixel's two depths
    must agree to N3MR_DEPTH_RTOL (an empty pixel against a drawn one
    fails that).  Elsewhere depth agrees to 1e-6 relative, weight to 1e-5,
    face_inv and zcorn exactly (both sides read them from the same rows)
    and rgb to 1e-5.  Returns (share of flipped pixels, max abs error of
    depth, weight and rgb over the other pixels); raises on a violation."""
    fi_g, fi_w = got[0], want[0]
    flip = fi_g != fi_w
    share = flip.double().mean().item()
    if share > N3MR_FLIP_FRAC:
        raise AssertionError(f'{share:.6f} of pixels have another winner '
                             f'(allowed {N3MR_FLIP_FRAC})')
    d_g, d_w = got[2].double(), want[2].double()
    if not ((d_g - d_w).abs() <= N3MR_DEPTH_RTOL * d_w.abs()).all():
        raise AssertionError('depths differ beyond 1e-6 relative '
                             f'(max {(d_g - d_w).abs().max().item():.3g})')
    same = ~flip
    err = (d_g - d_w).abs().max().item()
    for name, k, atol in (('weight', 1, 1e-5), ('face_inv', 3, 0.0), ('zcorn', 4, 0.0),
                          ('rgb', 5, 1e-5)):
        if k >= len(got) or got[k] is None:
            continue
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'non-finite {name}')
        d = (got[k].double() - want[k].double()).abs()[same]
        if d.numel() and d.max().item() > atol:
            raise AssertionError(f'{name} differs by {d.max().item():.3g} (allowed {atol})')
        if atol and d.numel():
            err = max(err, d.max().item())
    return share, err


def scaled_err(got, want):
    """max|got - want| / max|want|; raises on a shape mismatch or a
    non-finite entry of ``got``."""
    got, want = _tensor(got), _tensor(want)
    if got.shape != want.shape:
        raise AssertionError(f'shape {tuple(got.shape)}, expected {tuple(want.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite gradient')
    scale = max(want.double().abs().max().item(), 1e-30)
    return (got.double() - want.double()).abs().max().item() / scale
