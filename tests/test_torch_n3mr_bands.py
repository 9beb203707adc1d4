"""The N3MR edge kernels' band rule, on the CPU.

On the card the edge gradient (``csrc/n3mr_edgebwd.cu``) lists each
(face, edge, axis) item by the bands of ``EDGE_BAND`` d0 rows its edge
spans (an item over more than ``EDGE_SPAN`` bands goes to a global list),
stages each band's rows in shared memory, sums each (item, band) on its
own and adds an item's partial sums in ascending band order, as
``banded_bwd.build_band_lists`` and ``_axis_pass`` decompose the sweep.
``cuda_impl.band_keys_plain`` is the plain version of the lists and
``cuda_impl.edgebwd_bands_plain`` of the decomposition.  Here:

* the lists, global list included, cover each front item's rows exactly
  once, the rows ``torch_impl._edge_rows`` walks;
* the decomposition against the plane sweep
  (``torch_impl.backward_pixel_map``) within float32 rounding (2e-5 of
  max|grad|, the kernels' own tolerance: the partial sums add the same
  terms in another order), and against the JAX package's banded backward
  (``banded_bwd.backward_pixel_map_banded``, its XLA path on the CPU) at
  the edge gradients' 1e-3 of max|grad| (``tests/test_torch_n3mr.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.n3mr import banded_bwd
from jrender_tpu.ops.n3mr import impl as jimpl
from jrender_tpu_torch.ops.n3mr import cuda_impl as tcuda
from jrender_tpu_torch.ops.n3mr import torch_impl as timpl

torch.set_num_threads(2)

SUM_TOL = 2e-5       # the decomposition against the sweep, of max|grad|
EDGE_TOL = 1e-3      # against the JAX package, of max|grad| (test_torch_n3mr.py)


def scene(seed, F, is_, B=1, shrink=1.0):
    """Random triangles, their maps from the port's plain z-buffer, seeded
    rgb and incoming gradients: the edge gradient's arguments up to is_."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.95, 0.95, size=(B, F, 3, 2))
    ctr = xy.mean(2, keepdims=True)
    xy = ctr + (xy - ctr) * shrink
    z = rng.uniform(1.2, 4.0, size=(B, F, 3, 1))
    face = torch.tensor(np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9))
    fi = timpl.forward_maps(face, is_, 0.1, 100.0)[0]
    alpha = (fi >= 0).float()
    rgb = torch.tensor(rng.rand(B, is_, is_, 3).astype(np.float32))
    gr = torch.tensor(rng.randn(B, is_, is_, 3).astype(np.float32))
    ga = torch.tensor(rng.randn(B, is_, is_).astype(np.float32))
    return face, fi, rgb, alpha, gr, ga


def scaled(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize('is_,band', [(48, 4), (72, 2), (130, 4), (130, 8), (64, 1)])
def test_band_lists_cover_each_item_once(is_, band):
    face, *maps = scene(1, 60, is_, B=2)
    face[:, 3, 4] = float('nan')                   # a NaN corner lists nothing
    pp = tcuda.edge_inputs(face, *maps, is_, True, True)[0]
    keys, items = tcuda.band_keys_plain(pp, is_, band)
    keys, order = torch.sort(keys)
    B, F = face.shape[:2]
    N = 6 * B * F
    n_bands = -(-is_ // band)
    gk = band * 3 * F
    gbase = 2 * B * n_bands * gk
    it = order // tcuda.EDGE_SPAN
    first, last, nb = (items[:, k].long() for k in range(3))
    covered = torch.zeros((N, is_), dtype=torch.int64)
    rows = torch.arange(is_)
    for k in range(keys.numel()):
        key, i = int(keys[k]), int(it[k])
        if key < gbase:                            # listed: the band's rows of the item
            group = key // gk
            b0 = (group % n_bands) * band
            assert group // n_bands == i // (3 * F)              # its axis and batch element
            assert (key % gk) % (3 * F) == i % (3 * F)           # its face and edge
            assert (key % gk) // (3 * F) == max(int(first[i]) - b0, 0)   # its first row
            lo, hi = max(int(first[i]), b0), min(int(last[i]), b0 + band - 1)
        elif key < gbase + N:                      # global: all its rows
            assert key - gbase == i and nb[i] == -1
            lo, hi = int(first[i]), int(last[i])
        else:
            continue
        covered[i] += (rows >= lo) & (rows <= hi)
    assert int(covered.max()) == 1
    assert (nb < 0).any() and (nb > 0).any() and (nb <= tcuda.EDGE_SPAN).all()
    # the rows of each item are the sweep's own (torch_impl._edge_rows)
    fi_flat = torch.zeros(is_ * is_, dtype=torch.int64)
    for b in range(B):
        pp_b = pp[b, :, :6].reshape(F, 3, 2)
        front = pp[b, :, 6] > 0.5
        for e in range(3):
            for axis in range(2):
                r = timpl._edge_rows(pp_b, front, torch.arange(F), fi_flat, is_, e, axis)
                d0 = torch.arange(is_, dtype=pp.dtype)
                d0_from = torch.minimum(r.p00, r.p10).ceil().clamp_min(0.0)
                d0_to = torch.maximum(r.p00, r.p10).clamp_max(is_ - 1.0)
                walked = (d0 >= d0_from[:, None]) & (d0 <= d0_to[:, None]) & front[:, None]
                idx = ((axis * B + b) * F + torch.arange(F)) * 3 + e
                assert torch.equal(covered[idx].bool(), walked)


@pytest.mark.parametrize('rr,ra', [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize('band', [2, 4])
def test_band_decomposition_matches_the_sweep(rr, ra, band):
    args = scene(2, 40, 48, B=2)
    got = tcuda.edgebwd_bands_plain(*args, 48, 1e-3, rr, ra, band=band)
    want = timpl.backward_pixel_map(*args, 48, 1e-3, rr, ra)
    assert scaled(got, want) <= SUM_TOL
    assert (got[..., 2::3] == 0).all() and got.abs().max() > 0


def test_band_decomposition_global_items():
    """Triangles over most of the screen: many edges span more than
    EDGE_SPAN bands of one row and take the global list."""
    args = scene(3, 20, 40)
    pp = tcuda.edge_inputs(*args, 40, True, True)[0]
    nb = tcuda.band_keys_plain(pp, 40, 1)[1][:, 2]
    assert (nb < 0).sum() > 20 and (nb > 0).sum() > 5
    got = tcuda.edgebwd_bands_plain(*args, 40, 1e-3, True, True, band=1)
    assert scaled(got, timpl.backward_pixel_map(*args, 40, 1e-3, True, True)) <= SUM_TOL


def test_band_decomposition_matches_jax_banded():
    """The JAX package's banded backward on the JAX z-buffer's maps (its XLA
    path on the CPU), as ``test_torch_n3mr.py`` runs it."""
    rng = np.random.RandomState(4)
    F, is_ = 30, 40
    xy = rng.uniform(-0.95, 0.95, size=(F, 3, 2)).astype(np.float32)
    z = rng.uniform(1.2, 4.0, size=(F, 3, 1)).astype(np.float32)
    face = jnp.asarray(np.concatenate([xy, z], -1).reshape(F, 9))
    fi, wt, dp, _ = jimpl.forward_maps_single(face, is_, 0.1, 100.0)
    alpha = (fi >= 0).astype(jnp.float32)
    rgb = jnp.asarray(rng.rand(is_, is_, 3).astype(np.float32))
    ga = jnp.asarray(rng.randn(is_, is_).astype(np.float32))
    gr = jnp.asarray(rng.randn(is_, is_, 3).astype(np.float32))
    want = np.asarray(banded_bwd.backward_pixel_map_banded(
        face, fi, rgb, alpha, gr, ga, is_, 1e-3, True, True)).reshape(F, 9)
    args = [torch.tensor(np.asarray(a))[None] for a in (face, fi, rgb, alpha, gr, ga)]
    got = tcuda.edgebwd_bands_plain(*args, is_, 1e-3, True, True)[0].numpy()
    assert np.abs(got - want).max() <= EDGE_TOL * np.abs(want).max()


@pytest.mark.parametrize('is_,nch,want', [(64, 6, 64), (1024, 6, 1024), (1024, 8, 768),
                                          (2048, 6, 1024), (2048, 2, 2048), (8192, 8, 768)])
def test_edge_segment_width(is_, nch, want):
    """A band block stages EDGE_BAND rows of the face index and the nch
    channels: whole rows where they fit EDGE_SMEM_BYTES, else column
    segments of a multiple of 32."""
    w = tcuda.edge_segment_width(is_, nch)
    assert w == want
    assert 4 * tcuda.EDGE_BAND * (1 + nch) * w <= tcuda.EDGE_SMEM_BYTES
