"""The f_px and px_f forward kernels' split and merge rule, on the CPU.

On the card the forward of the f_px and px_f routes
(``csrc/softras_tile_fwd.cuh``) cuts each tile's list (its big faces, then
its sorted run) into contiguous shares, one per block of a thread-block
cluster, and merges the blocks' partial states in rank order; the px_f
threshold merges the ranks' K-smallest lists (K <= 32) or sums their
bisection counts.  ``tiled.fwd_split_plain`` is the plain version of that
rule: the shares of ``cuda_impl.rank_shares`` aggregated by the pxg
partials' plain version, merged by the pxg combine's rule, the threshold
from the shares' K-smallest lists.  Here it is held

* against the unsplit plain forward (``tiled.fwd_plain``) at 2, 4 and 8
  ranks, on both routes: candidate counts, hard winners and their depths
  and the threshold maps exactly (the merge picks the least depth and the
  lowest id across shares, as one walk does, and the K-th smallest of a
  union is a value of the union), images and softmax aggregates within
  1e-5 (the shares' sums are rescaled and added in another order);
* against the JAX package's f_px and px_f forwards (interpret mode) at
  their own suites' tolerances (``tests/test_torch_fpx.py``,
  ``tests/test_torch_pxf.py``).

The soups are dense at 64 px, so that the busiest tile's list has a face
for every rank.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import (binning, cuda_impl, fpx_impl, make_params, pxf_impl,
                                          tiled)

from conftest import make_random_mesh
from test_torch_fpx import fpx_on  # noqa: F401  (a fixture)
from test_torch_pxf import pxf_on  # noqa: F401  (a fixture)
from test_torch_softras import (assert_close_except_edges, assert_rgb_close, soup,
                                texel_tie_variants)

torch.set_num_threads(2)

SUM_TOL = 1e-5
KW = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3)
SPLITS = (2, 4, 8)


def dense_soup(seed, F=160, T=4, radius=(0.05, 0.15)):
    """Small faces over the whole 64-px image: every f_px (16 x 64) and
    px_f (32 x 32) tile's list holds dozens of faces."""
    return soup(np.random.RandomState(seed), F=F, T=T, centre=(-0.8, 0.8), radius=radius)


def prep(route, fv, tex, p, mt=None, band=None):
    """The route's tiled inputs; ``mt``: the binning's emit cap (a face over
    more tiles goes to the big-face list); ``band``: (ty0, ty_band)."""
    fvt, text = torch.as_tensor(fv), torch.as_tensor(tex)
    if route == 'fpx':
        th, tw = fpx_impl.tile_shape(p.image_size)
        group = fpx_impl.GROUP
    else:
        th = tw = pxf_impl.tile_for(p.image_size)
        group = pxf_impl.GROUP
    pin = tiled.prep(fvt, text, p, th, tw, group, band=band)
    if mt is not None:
        B, F = fvt.shape[:2]
        lists = binning.build_tile_lists_compact(fvt.reshape(B, F, 9), p.image_size, th, tw,
                                                 p.threshold, mt)
        work = tiled.tile_work(lists, B, F, pin.tiles_y, pin.tiles_x, group, False, band)
        pin = pin._replace(**work._asdict())
    return pin


def longest(pin):
    return int((pin.tile_off[1:] - pin.tile_off[:-1]).max())


def assert_merge_exact(got, want, p, with_thr):
    """Counts, hard winners and thresholds exact, sums within SUM_TOL."""
    (img, ag, cnt, thr), (img_w, ag_w, cnt_w, thr_w) = got, want
    assert torch.equal(cnt, cnt_w)
    torch.testing.assert_close(img, img_w, atol=SUM_TOL, rtol=0)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag, ag_w)               # the winner's depth and id
    else:
        torch.testing.assert_close(ag, ag_w, atol=SUM_TOL, rtol=SUM_TOL)
    if with_thr:
        assert torch.equal(thr, thr_w)
        assert (thr[cnt <= p.max_faces_id] == p.far).all()
    else:
        assert thr is None and thr_w is None


@pytest.mark.parametrize('alpha', ['hard', 'sum', 'prod'])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
@pytest.mark.parametrize('split', SPLITS)
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_split_matches_unsplit(route, split, rgb, alpha):
    fv, tex = dense_soup(1)
    p = make_params(aggr_func_rgb=rgb, aggr_func_alpha=alpha, max_faces_per_pixel_for_grad=4,
                    **KW)
    pin = prep(route, fv, tex, p)
    assert longest(pin) >= 4 * split             # every rank of the busiest tile works
    with_thr = route == 'pxf'
    assert_merge_exact(tiled.fwd_split_plain(pin, p, with_thr, split),
                       tiled.fwd_plain(pin, p, with_thr), p, with_thr)


@pytest.mark.parametrize('dist', ['hard', 'barycentric'])
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_split_other_distances(route, dist):
    fv, tex = dense_soup(2)
    p = make_params(dist_func=dist, max_faces_per_pixel_for_grad=4, **KW)
    pin = prep(route, fv, tex, p)
    with_thr = route == 'pxf'
    assert_merge_exact(tiled.fwd_split_plain(pin, p, with_thr, 8),
                       tiled.fwd_plain(pin, p, with_thr), p, with_thr)


@pytest.mark.parametrize('K', [4, 16, 40])
@pytest.mark.parametrize('split', SPLITS)
def test_split_threshold_exact(split, K):
    """Larger faces: up to about 70 candidates a pixel, so that K = 40 binds
    (the kernel's bisection, whose counts the ranks sum) and K = 4 and 16
    (the K-smallest lists, which rank 0 merges)."""
    fv, tex = dense_soup(3, F=300, T=1, radius=(0.3, 0.6))
    p = make_params(max_faces_per_pixel_for_grad=K, **KW)
    pin = prep('pxf', fv, tex, p)
    got = tiled.fwd_split_plain(pin, p, True, split)
    want = tiled.fwd_plain(pin, p, True)
    assert (want[2] > K).float().mean() > 0.2 and (want[2] <= K).any()
    assert_merge_exact(got, want, p, True)


@pytest.mark.parametrize('route,band', [('pxf', (1, 1)), ('fpx', None)])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_split_big_faces_cross_ranks(route, band, rgb):
    """An emit cap of 2 tiles: most faces are big, and the big-face prefix
    of a tile's list spans several ranks' shares; on px_f the second tile
    row alone (ty0 = 1), whose outputs are band-local."""
    fv, tex = dense_soup(4, F=200, radius=(0.2, 0.5))
    p = make_params(aggr_func_rgb=rgb, max_faces_per_pixel_for_grad=16, **KW)
    pin = prep(route, fv, tex, p, mt=2, band=band)
    nbig = int(binning.build_tile_lists_compact(
        torch.as_tensor(fv), 64, pin.tile_h, pin.tile_w, p.threshold, 2).gcount.max())
    assert nbig > -(-longest(pin) // 8)            # the big faces fill more than one share
    with_thr = route == 'pxf'
    got = tiled.fwd_split_plain(pin, p, with_thr, 8)
    assert_merge_exact(got, tiled.fwd_plain(pin, p, with_thr), p, with_thr)
    if band is not None:
        assert got[0].shape == (1, 4, 32, 64)
        whole = tiled.fwd_split_plain(prep(route, fv, tex, p, mt=2), p, True, 8)
        for part, full in zip(got, whole):
            assert torch.equal(part, full[..., 32:, :])


@pytest.mark.parametrize('mt', [None, 2])
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_split_ties_go_to_the_lowest_id(route, mt):
    """Faces F..2F-1 repeat faces 0..F-1 (other colours): every depth tie
    between a face and its twin, which lie in different shares, goes to the
    lower id; with an emit cap of 2 tiles most twins are big faces.  On
    px_f each depth counts twice towards K."""
    fv, tex = dense_soup(5, F=80)
    fv2 = np.concatenate([fv, fv], axis=1)
    tex2 = np.concatenate([tex, tex[..., ::-1]], axis=1).copy()
    p = make_params(aggr_func_rgb='hard', max_faces_per_pixel_for_grad=3, **KW)
    pin = prep(route, fv2, tex2, p, mt=mt)
    with_thr = route == 'pxf'
    got = tiled.fwd_split_plain(pin, p, with_thr, 8)
    assert_merge_exact(got, tiled.fwd_plain(pin, p, with_thr), p, with_thr)
    won = got[1][:, 1]
    assert (won >= 0).any() and not (won >= 80).any()


@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_split_lone_faces_rank_zero_alone(route):
    """One small face in each of a few tiles and tiles without faces: every
    list holds at most one face, which rank 0 walks alone; the empty tiles
    get the background and the initial aggregates."""
    rng = np.random.RandomState(6)
    centres = [(-0.75, -0.75), (0.75, 0.75)]
    fv = np.array([[[x - 0.05, y - 0.05, 2.5, x + 0.05, y - 0.05, 2.4, x, y + 0.05, 2.6]
                    for x, y in centres]], np.float32)
    tex = rng.uniform(size=(1, len(centres), 4, 3)).astype(np.float32)
    for rgb in ('softmax', 'hard'):
        p = make_params(aggr_func_rgb=rgb, image_size=64, max_faces_per_pixel_for_grad=1,
                        background_color=(0.2, 0.4, 0.6))
        pin = prep(route, fv, tex, p)
        sizes = pin.tile_off[1:] - pin.tile_off[:-1]
        assert int(sizes.max()) == 1 and (sizes == 0).any()
        with_thr = route == 'pxf'
        got = tiled.fwd_split_plain(pin, p, with_thr, 8)
        assert_merge_exact(got, tiled.fwd_plain(pin, p, with_thr), p, with_thr)


def test_split_plain_is_the_unsplit_one_at_one_rank():
    """With one rank the split rule is a walk of the whole list: counts,
    winners and thresholds equal, sums within rounding of the unsplit
    plain version's."""
    fv, tex = dense_soup(7)
    p = make_params(aggr_func_rgb='hard', max_faces_per_pixel_for_grad=16, **KW)
    pin = prep('pxf', fv, tex, p)
    assert_merge_exact(tiled.fwd_split_plain(pin, p, True, 1), tiled.fwd_plain(pin, p, True),
                       p, True)


# --------------------------------------------------------------------------
# against the JAX package's f_px and px_f forwards (interpret mode)
# --------------------------------------------------------------------------

def split_forward(route, fv, tex, p, band=None, dtype=torch.float32):
    """The split rule at 8 ranks on the route's inputs: (images, aggrs,
    counts, thr or None)."""
    pin = prep(route, torch.tensor(fv, dtype=dtype), torch.tensor(tex, dtype=dtype), p,
               band=band)
    assert longest(pin) >= 8                       # every rank of the busiest tile works
    return tiled.fwd_split_plain(pin, p, route == 'pxf', 8)


def check_split_against_jax(route, fv, tex, p, oj, aj, band=None):
    """The split rule's images against a JAX layout's at that layout's
    suite's tolerances: rgb within 2e-5 except knife-edge pixels (a texel
    tie, or the plain version's own float32 rounding), alpha and the
    aggregates atol 5e-4 + rtol 1e-4 on all but 1% of the pixels (the
    JAX kernels multiply 1 - sf as a tree), hard winners exactly."""
    img, ag, cnt, thr = out = split_forward(route, fv, tex, p, band)
    ties = texel_tie_variants(lambda: split_forward(route, fv, tex, p, band)[0])
    exact = split_forward(route, fv, tex, p, band, torch.float64)[0]
    assert_rgb_close(img.numpy()[:, :3], oj[:, :3], ties[:, :, :3], exact.numpy()[:, :3])
    assert_close_except_edges(img.numpy()[:, 3], oj[:, 3], 5e-4, 1e-4)
    if p.aggr_func_rgb == 'hard':
        np.testing.assert_array_equal(ag.numpy()[:, 1], aj[:, 1])
    else:
        assert_close_except_edges(ag.numpy(), aj, 5e-4, 1e-4, pixel_axis=1)
    return out


@pytest.mark.parametrize('size,kw', [
    (32, dict()),
    (48, dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')),
], ids=['32-softmax-prod', '48-hard'])
def test_split_against_jax_fpx(size, kw, rng, fpx_on):
    """``soft_rasterize_fwd_pallas`` against the split rule at 8 ranks on
    the JAX suite's random mesh (``test_torch_fpx.test_forward_against_jax_fpx``'s
    inputs and tolerances)."""
    F = 40
    fv = make_random_mesh(rng, num_faces=F).reshape(1, F, 9)
    tex = rng.uniform(size=(1, F, 4, 3)).astype(np.float32)
    kw = dict(image_size=size, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=F,
              **kw)
    p = make_params(**kw)
    oj, aj, _ = (np.asarray(a) for a in pallas_impl.soft_rasterize_fwd_pallas(
        jnp.asarray(fv), jnp.asarray(tex), jax_params(**kw)))
    check_split_against_jax('fpx', fv, tex, p, oj, aj)


def test_split_against_jax_pxf(rng, pxf_on):
    """``soft_rasterize_fwd_pallas_pf`` with the threshold against the split
    rule at 8 ranks, on the second tile row of a 64-px image (ty0 = 1):
    the images as above, counts exact, thresholds to 1e-6 relative on all
    but 1% of the pixels where the truncation binds (``check_against_jax_pf``)."""
    F, K = 40, 3
    fv, tex = soup(rng, F=F, T=4, radius=(0.2, 0.45))
    kw = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=K)
    p = make_params(**kw)
    oj, aj, auxj = (np.asarray(a) for a in pallas_impl.soft_rasterize_fwd_pallas_pf(
        jnp.asarray(fv), jnp.asarray(tex), jax_params(**kw), True, jnp.asarray(1, jnp.int32), 1))
    _, _, cnt, thr = check_split_against_jax('pxf', fv, tex, p, oj, aj, band=(1, 1))
    np.testing.assert_array_equal(cnt.numpy(), auxj[:, 0])
    binding = cnt.numpy() > K
    assert binding.any()
    t_got, t_want = thr.numpy()[binding], auxj[:, 1][binding]
    assert (np.abs(t_got - t_want) > 1e-6 * np.abs(t_want)).mean() <= 0.01


def test_split_chunk_fits_the_block():
    """The forward stages two chunks of face rows in what 48 KB leaves
    beside the threshold's lists (at least 24 KB), at most 64 faces and 32
    a warp; one face of many texels asks past 48 KB, up to a block's most."""
    for K, with_thr in ((16, False), (16, True), (32, True), (40, True)):
        p = make_params(image_size=64, max_faces_per_pixel_for_grad=K)
        own = tiled.fwd_own_bytes(p, with_thr)
        for T in (1, 25, 324, 4096):
            row = cuda_impl.ROW_BASE + 3 * T
            for threads in (32, 128, 256):
                chunk = tiled.fwd_chunk(row, threads, own)
                assert 1 <= chunk <= min(cuda_impl.MAX_CHUNK, threads)
                assert chunk == 1 or 8 * chunk * (row + 1) <= max(cuda_impl.SMEM_BYTES - own,
                                                                   cuda_impl.SMEM_BYTES // 2)
    assert tiled.fwd_own_bytes(make_params(max_faces_per_pixel_for_grad=16), True) \
        == 4 * 17 * tiled.FWD_PIX
    assert [tiled.fwd_threads(*s) for s in ((16, 128), (32, 32), (16, 16), (8, 8), (16, 48))] \
        == [256, 256, 128, 32, 256]
    with pytest.raises(ValueError):
        tiled.fwd_threads(16, 20)
    with pytest.raises(ValueError):
        tiled.fwd_chunk(cuda_impl.ROW_BASE + 3 * 10000, 256, 0)
