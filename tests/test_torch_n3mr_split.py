"""The z-buffer kernel's split and its warp corner test, as plain rules, on the CPU.

The z-buffer kernel (``csrc/n3mr_maps.cu``) splits each tile's face list
over a cluster of ``split`` blocks, each walking a contiguous share and
keeping a pixel's least (depth, id), rank 0 merging the shares' states by
the same rule; a warp skips a face whose edge rejects the warp's corner
pixels.  ``n3mr.cuda_impl.maps_split_plain`` is the plain version of that
rule (with ``warp_skip_plain`` for the skip), and here it is held bit for
bit against the unsplit plain z-buffer (``torch_impl.forward_maps``) at
1, 2, 4 and 8 blocks a tile, and against the JAX package's z-buffer (its
XLA path and its Pallas kernel in interpret mode, as
``tests/test_torch_n3mr.py`` runs them).  The soups hold equal-depth twins
(a face and its copy: the lower id wins), back faces, big faces of the
binning (an emit cap of 4 tiles), a screen-filling face, zero-area and NaN
faces, and a list of one face.

The corner test is exact, not a widened bbox: each side of an edge's
inside test is a monotone function of one pixel coordinate in round-to-
nearest arithmetic, so a face it skips for a warp has no (face, pixel)
pair there that passes the strict inside test.  That is checked on every
pair of random faces and of faces whose edges pass through pixel centres
(where the inside test is decided by the last bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrender_tpu.ops.n3mr import impl as jimpl
from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
from jrender_tpu_torch.ops.n3mr import torch_impl as nplain
from jrender_tpu_torch.ops.softras import binning
from jrender_tpu_torch.utils.checks import n3mr_special_faces

torch.set_num_threads(2)

SPLITS = (1, 2, 4, 8)


def soup(seed, F, B=1, shrink=0.5, z=(1.2, 4.0)):
    """Random triangles in NDC, both windings (about half are back faces)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.95, 0.95, size=(B, F, 3, 2))
    ctr = xy.mean(2, keepdims=True)
    xy = ctr + (xy - ctr) * shrink
    zz = rng.uniform(*z, size=(B, F, 3, 1))
    return torch.tensor(np.concatenate([xy, zz], -1).astype(np.float32).reshape(B, F, 9))


def with_twins(face, n=20):
    """Faces n..2n-1 replaced by copies of faces 0..n-1: equal depths at
    every pixel, so the lower id must win."""
    face = face.clone()
    face[:, n:2 * n] = face[:, :n]
    return face


def back_faces(face, every=3):
    """Every ``every``-th face with two corners swapped: the other winding."""
    face = face.clone().reshape(*face.shape[:2], 3, 3)
    face[:, ::every, [1, 2]] = face[:, ::every, [2, 1]]
    return face.reshape(*face.shape[:2], 9)


def big_face_lists(face, is_):
    """Tile lists with an emit cap of 4 tiles: most faces go through the
    big-face list."""
    neg_y = face * face.new_tensor([1.0, -1.0, 1.0] * 3)
    return binning.build_tile_lists_compact(neg_y, is_, ncuda.TILE, ncuda.TILE, 0.0, 4)


def assert_maps_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


CASES = {
    'soup-twins': lambda: with_twins(back_faces(soup(1, 150, B=2))),
    'special-faces': lambda: n3mr_special_faces(soup(2, 120, B=2, shrink=0.6)),
    'dense-slivers': lambda: soup(3, 300, shrink=0.15, z=(2.0, 2.05)),
    'one-face': lambda: soup(4, 1, shrink=3.0),
}


@pytest.mark.parametrize('skip', [False, True], ids=['walk', 'corner-skip'])
@pytest.mark.parametrize('split', SPLITS)
@pytest.mark.parametrize('case', list(CASES))
def test_split_equals_the_unsplit_z_buffer(case, split, skip):
    """Every share walked by the thread's rule and merged by (depth, id)
    gives the unsplit z-buffer's maps, bit for bit."""
    face = CASES[case]()
    is_ = 72 if case == 'special-faces' else 64
    want = nplain.forward_maps(face, is_, 0.1, 100.0)
    got = ncuda.maps_split_plain(face, is_, 0.1, 100.0, split, skip)
    assert_maps_equal(got, want)
    assert (want[0] >= 0).any()
    if case == 'soup-twins':
        assert not ((want[0] >= 20) & (want[0] < 40)).any()      # the copies never win
        assert ((want[0] >= 0) & (want[0] < 20)).any()


@pytest.mark.parametrize('split', [1, 3, 8])
def test_split_through_the_big_face_list(split):
    """With an emit cap of 4 tiles most faces reach a tile through the
    big-face list, whose entries come first in a share: the same maps."""
    face = n3mr_special_faces(back_faces(soup(5, 100, B=2, shrink=0.8)))
    lists = big_face_lists(face, 64)
    assert int(lists.gcount.min()) >= 10
    want = nplain.forward_maps(face, 64, 0.1, 100.0)
    assert_maps_equal(ncuda.maps_split_plain(face, 64, 0.1, 100.0, split, True, lists), want)


@pytest.mark.parametrize('split', [1, 4])
def test_split_matches_jax(split):
    """The split's maps against the JAX z-buffer: its XLA path and its Pallas
    kernel in interpret mode, at tests/test_torch_n3mr.py's tolerances (face
    ids equal; depth 1e-4, weight 5e-4, inverse 1e-3 + 2e-5 relative)."""
    from jrender_tpu.ops.n3mr.pallas_impl import forward_maps_pallas
    face = with_twins(back_faces(soup(6, 60, B=1, shrink=0.4)), 10)
    fi, wt, dp, finv, zc = ncuda.maps_split_plain(face, 64, 0.1, 100.0, split, True)
    ref_xla = jax.vmap(lambda f: jimpl.forward_maps_single(f, 64, 0.1, 100.0))(
        jnp.asarray(face.numpy()))
    refs = [ref_xla] + ([forward_maps_pallas(jnp.asarray(face.numpy()), 64, 0.1, 100.0)]
                        if split == 4 else [])
    for ref in refs:
        np.testing.assert_array_equal(fi.numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(dp.numpy(), np.asarray(ref[2]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(wt.numpy(), np.asarray(ref[1]), atol=5e-4)
        np.testing.assert_allclose(finv.numpy(), np.asarray(ref[3]), atol=1e-3, rtol=2e-5)
    assert int((fi >= 0).sum()) > 100


def strict_inside(rows, is_):
    """[B, F, is*is] whether each (face, pixel) pair passes the strict
    inside test, whatever the face's winding (torch_impl._pair_terms with
    every face taken as a front face)."""
    rows = rows.clone()
    rows[..., nplain.ROW_FRONT] = 1.0
    XI, YI, xp, yp = nplain._pixel_coords(torch.arange(is_ * is_), is_, rows.dtype)
    inside, _, _ = nplain._pair_terms(rows[:, :, None], XI, YI, xp, yp)
    return inside


def assert_skip_keeps_every_inside_pair(face, is_):
    rows = nplain.face_rows(face, is_)
    skip = ncuda.warp_skip_plain(rows, is_)                       # [B, F, wy, wx]
    inside = strict_inside(rows, is_)                             # [B, F, is*is]
    px = torch.arange(is_ * is_)
    at_px = skip[:, :, (px // is_) // 4, (px % is_) // 8]         # [B, F, is*is]
    assert inside.any()
    assert not (inside & at_px).any()
    return skip


@pytest.mark.parametrize('is_', [32, 40, 64])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_corner_skip_keeps_every_inside_pair_random_faces(seed, is_):
    face = back_faces(soup(10 + seed, 200, B=2, shrink=0.3))
    face = n3mr_special_faces(face)
    skip = assert_skip_keeps_every_inside_pair(face, is_)
    assert skip.float().mean() > 0.5          # and it skips most (face, warp) pairs


@pytest.mark.parametrize('is_', [16, 24, 32])
def test_corner_skip_keeps_every_inside_pair_edges_through_centres(is_):
    """Triangles whose corners are pixel centres: their edges run through
    rows, columns and diagonals of centres, where the strict test is decided
    by rounding; none of those pairs may be skipped."""
    rng = np.random.RandomState(is_)
    c = (2.0 * np.arange(is_) + 1 - is_) / is_                      # the centres
    corners = c[rng.randint(0, is_, size=(1, 400, 3, 2))]
    # axis-aligned and diagonal edges: share a coordinate or step evenly
    corners[0, :100, 1, 0] = corners[0, :100, 0, 0]
    corners[0, 100:200, 1, 1] = corners[0, 100:200, 0, 1]
    k = rng.randint(1, is_ // 2, size=100)
    i0 = rng.randint(0, is_ // 2, size=(100, 2))
    corners[0, 200:300, 0] = c[i0]
    corners[0, 200:300, 1] = c[i0 + k[:, None]]
    z = rng.uniform(1.5, 3.0, size=(1, 400, 3, 1))
    face = torch.tensor(np.concatenate([corners, z], -1).astype(np.float32).reshape(1, 400, 9))
    assert_skip_keeps_every_inside_pair(face, is_)
    assert_skip_keeps_every_inside_pair(back_faces(face, 1), is_)


def test_corner_skip_never_skips_by_a_non_finite_edge():
    """An edge whose vector is not finite (a NaN or infinite corner, or a
    difference that overflows) skips nothing; a finite edge of the same face
    still may."""
    face = soup(20, 4)
    face[0, 0, [0, 1, 3, 4, 6, 7]] = float('nan')
    face[0, 1, [0, 3, 6]] = torch.tensor([float('inf'), -float('inf'), float('inf')])
    face[0, 2, [0, 3]] = torch.tensor([3e38, -3e38])         # edge 0 overflows
    skip = ncuda.warp_skip_plain(nplain.face_rows(face, 32), 32)
    assert not skip[0, :2].any()
    assert skip[0, 3].any()
    assert_skip_keeps_every_inside_pair(face, 32)
