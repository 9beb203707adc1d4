"""The f_px and px_f backwards' work items and texel sums, on the CPU.

On the card the backward of the f_px and px_f routes
(``csrc/softras_tile_bwd.cuh``) runs a block per work item (a tile and a
run of at most the route's ``GROUP`` faces of its list, ``tiled.tile_work``)
and a warp per entry: each entry's row is one warp's walk of the face's
bbox inside the tile, so it does not depend on the item that holds the
entry, and the kernel's rows are bit-equal at every item size (the GPU
tests in ``tests/test_torch_kernels.py``).  Here:

* the item rule: every entry in exactly one item, items in list order
  inside their tile, none larger than the group;
* the plain rows (``tiled.bwd_rows_plain``, run item by item) at groups 1,
  3, 32 and 128, for whole tiles and for a px_f band with ty0 > 0: equal
  within 1e-6 of max|row| (PyTorch's reductions and matrix products add in
  another order when an item holds another number of faces; read: at most
  1.6e-7 of max|row|);
* the route's gradient at its own item size and at another against the
  JAX f_px and px_f backwards in interpret mode at 32 px, at
  ``tests/test_torch_fpx.py``'s and ``tests/test_torch_pxf.py``'s
  tolerances;
* the kernel's texel adds in rounds (``add_pair_rounds``: the lanes that
  select one texel form a group, round r adds each group's r-th lane) in
  a plain mirror: bit-equal to the adds one lane after the other, and on
  a real entry's pixels, within 1e-6 of max|row| of ``bwd_rows_plain``'s
  texture columns.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import fpx_impl, make_params, pxf_impl, tiled, torch_impl
from jrender_tpu_torch.utils.checks import fold_ties, tie_symmetric

from test_torch_fpx import fpx_on  # noqa: F401  (a fixture)
from test_torch_pxf import pxf_on  # noqa: F401  (a fixture)
from test_torch_softras import assert_grad_close, soup

torch.set_num_threads(2)

GROUPS = (1, 3, 32, 128)
ROW_TOL = 1e-6     # of max|row|: the plain rows at two item sizes
KW = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3)


def dense_soup(seed, F=160, T=4):
    """Small faces over the whole 64-px image: every tile's list holds
    dozens of faces, the busiest over a hundred at 16 x 64."""
    return soup(np.random.RandomState(seed), F=F, T=T, centre=(-0.8, 0.8), radius=(0.05, 0.15))


def tile_of(route, size):
    return fpx_impl.tile_shape(size) if route == 'fpx' else (pxf_impl.tile_for(size),) * 2


def prep(route, fv, tex, p, group, band=None):
    th, tw = tile_of(route, p.image_size)
    return tiled.prep(torch.as_tensor(fv), torch.as_tensor(tex), p, th, tw, group,
                      for_grad=True, band=band)


@pytest.mark.parametrize('group', GROUPS)
@pytest.mark.parametrize('route,band', [('fpx', None), ('pxf', None), ('pxf', (1, 1))],
                         ids=['fpx', 'pxf', 'pxf band'])
def test_items_hold_each_entry_once(route, band, group):
    fv, tex = dense_soup(1)
    pin = prep(route, fv, tex, make_params(**KW), group, band)
    E = pin.entries.numel()
    assert E > 0
    it = pin.items.long()
    held = torch.zeros(E, dtype=torch.long)
    for g, first, end in it.tolist():
        assert 1 <= end - first <= group
        held[first:end] += 1
    assert torch.equal(held, torch.ones_like(held))
    # a tile's items cut its list in order
    off, ioff = pin.tile_off.long(), pin.item_off.long()
    for g in range(off.numel() - 1):
        its = it[ioff[g]:ioff[g + 1]]
        if off[g] == off[g + 1]:
            assert its.numel() == 0
            continue
        assert (its[:, 0] == g).all()
        assert int(its[0, 1]) == int(off[g]) and int(its[-1, 2]) == int(off[g + 1])
        assert torch.equal(its[1:, 1], its[:-1, 2])
    assert int(ioff[-1]) == it.shape[0]


@pytest.mark.parametrize('case', ['fpx softmax', 'fpx hard', 'pxf softmax K=4', 'pxf band',
                                  'pxf vertex'])
def test_rows_plain_do_not_depend_on_the_item_size(case):
    route = case.split()[0]
    rgb = 'hard' if 'hard' in case else 'softmax'
    vertex = 'vertex' in case
    fv, tex = dense_soup(2, T=3 if vertex else 4)
    if vertex:
        tex = tex.reshape(1, -1, 3, 3)
    kw = dict(KW, aggr_func_rgb=rgb, texture_type='vertex' if vertex else 'surface')
    if route == 'fpx':
        p = make_params(grad_mode='full', **kw)
    else:
        p = make_params(max_faces_per_pixel_for_grad=4, **kw)
    band = (1, 1) if case == 'pxf band' else None
    with_thr = route == 'pxf'
    rows = {}
    for group in GROUPS:
        pin = prep(route, fv, tex, p, group, band)
        img, ag, _, thr = tiled.fwd_plain(pin, p, with_thr)
        if group == GROUPS[0]:
            g = torch.tensor(np.random.RandomState(3).randn(*img.shape).astype(np.float32))
            longest = int((pin.tile_off[1:] - pin.tile_off[:-1]).max())
            assert longest > 32                     # several items of 32 a tile
        rows[group] = tiled.bwd_rows_plain(pin, img, ag, thr, g, p)
    scale = rows[1].abs().max()
    assert scale > 0
    for group in GROUPS[1:]:
        assert (rows[group] - rows[1]).abs().max() <= ROW_TOL * scale, group


def test_backward_items_against_jax_fpx(rng, fpx_on):
    """The f_px gradient (untruncated) on items of fpx_impl.GROUP and of 8
    faces against ``soft_rasterize_bwd_pallas`` (interpret mode) on its own
    forward, at 32 px."""
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    fv, tex = soup(rng, F=60, T=4, radius=(0.15, 0.4))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = pallas_impl.soft_rasterize_fwd_pallas(fj, tj, pj)
    gfj, gtj = pallas_impl.soft_rasterize_bwd_pallas(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    p = make_params(grad_mode='full', **kw)
    for group in (fpx_impl.GROUP, 8):
        pin = prep('fpx', fv, tex, p, group)
        assert group == fpx_impl.GROUP or pin.items.shape[0] > pin.tile_off.numel() - 1
        img, ag, _, _ = fpx_impl.forward(pin, p)
        gf, gt = fpx_impl.backward(pin, img, ag, None, torch.tensor(g), p)
        assert_grad_close(gf.numpy(), np.asarray(gfj))
        assert_grad_close(fold_ties(gt.numpy()), fold_ties(np.asarray(gtj)))


@pytest.mark.parametrize('band', [None, (1, 1)])
def test_backward_items_against_jax_pxf(band, rng, pxf_on):
    """The px_f gradient, the truncation binding (K = 4), on items of
    pxf_impl.GROUP and of 8 faces against ``soft_rasterize_bwd_pallas_pf``
    (interpret mode) on its own forward: the whole image at 32 px, and the
    second band of tile rows at 64 px (ty0 = 1)."""
    size = 32 if band is None else 64
    kw = dict(image_size=size, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    fv, tex = soup(rng, F=60, T=4, radius=(0.15, 0.4))
    tex = tie_symmetric(tex)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    jband = () if band is None else (jnp.asarray(band[0], jnp.int32), band[1])
    oj, aj, auxj = pallas_impl.soft_rasterize_fwd_pallas_pf(fj, tj, pj, True, *jband)
    assert float(auxj[:, 0].max()) > 4
    rows = oj.shape[2]
    g = rng.randn(1, 4, rows, size).astype(np.float32)
    gfj, gtj = pallas_impl.soft_rasterize_bwd_pallas_pf(fj, tj, oj, aj, auxj, jnp.asarray(g),
                                                        pj, *jband)
    p = make_params(**kw)
    for group in (pxf_impl.GROUP, 8):
        pin = prep('pxf', fv, tex, p, group, band)
        img, ag, _, thr = pxf_impl.forward(pin, p, True)
        gf, gt = pxf_impl.backward(pin, img, ag, thr, torch.tensor(g), p)
        assert_grad_close(gf.numpy(), np.asarray(gfj))
        assert_grad_close(fold_ties(gt.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# the texel adds in rounds (add_pair_rounds in csrc/softras_tile_bwd.cuh)
# --------------------------------------------------------------------------

def texel_sums_serial(idx, val, valid, T):
    """add_pair's texel adds (softras_grad.cuh): step after step, the valid
    lanes one after the other in ascending order, in float32.  idx [S, 32],
    val [S, 32, 3], valid [S, 32].  Returns [T, 3]."""
    out = np.zeros((T, 3), np.float32)
    for s in range(idx.shape[0]):
        for lane in range(32):
            if valid[s, lane]:
                out[idx[s, lane]] = out[idx[s, lane]] + val[s, lane]
    return out


def texel_sums_rounds(idx, val, valid, T):
    """The kernel's rule in rounds: in each step the valid lanes that select
    one texel form a group (``__match_any_sync``); round r adds the value of
    each group's r-th lane (its rank: the group's lanes below it), all
    groups at once, in float32; as many rounds as the largest group has
    lanes (``__reduce_max_sync``)."""
    out = np.zeros((T, 3), np.float32)
    lanes = np.arange(32)
    for s in range(idx.shape[0]):
        key = np.where(valid[s], idx[s], -1)
        same = key[:, None] == key[None, :]                       # [lane, other]
        rank = (same & (lanes[None, :] < lanes[:, None])).sum(1)
        size = np.where(valid[s], same.sum(1), 0)
        for q in range(int(size.max(initial=0))):
            adds = valid[s] & (rank == q)
            # one lane a texel in a round: the adds of a round are independent
            assert len(set(idx[s][adds].tolist())) == int(adds.sum())
            out[idx[s][adds]] = out[idx[s][adds]] + val[s][adds]
    return out


def test_texel_rounds_on_an_entry_against_rows_plain(rng):
    """One px_f entry of a soup at 32 px: its pixels' texel and value (the
    plain backward of each pixel alone), laid out as the kernel's warp walks
    the face's bbox inside the tile (row-major, 32 pixels a step), summed
    in rounds, against ``bwd_rows_plain``'s texture columns of that entry."""
    p = make_params(image_size=32, sigma_val=1e-3, gamma_val=1e-3, grad_mode='full')
    fv, tex = soup(rng, F=12, T=9, radius=(0.3, 0.5))
    pin = prep('pxf', fv, tex, p, pxf_impl.GROUP)
    img, ag, _, thr = tiled.fwd_plain(pin, p, False)
    g = torch.tensor(rng.randn(*img.shape).astype(np.float32))
    rows = tiled.bwd_rows_plain(pin, img, ag, thr, g, p)
    T = 9
    tex_cols = rows[:, 9:].reshape(-1, T, 3)
    e = int(tex_cols.abs().sum((1, 2)).argmax())                  # the busiest entry
    tile_g = int(torch.searchsorted(pin.tile_off, torch.tensor(e), right=True)) - 1
    ty, tx = divmod(tile_g % (pin.tiles_y * pin.tiles_x), pin.tiles_x)
    fid = int(pin.entries[e])
    rr, cc = tiled._tile_pixels(pin, ty, tx, 32, torch.device('cpu'))
    xp, yp = torch_impl.pixel_centers(rr, cc, 32)
    r = pin.rows[0, fid:fid + 1]
    vals = []
    for k in range(rr.numel()):           # each pixel alone: one texel or none
        _, gt = torch_impl.backward_single(
            r[:, :9], tiled._tex(pin, p, r), img[0][:, rr[k:k + 1], cc[k:k + 1]].T,
            ag[0][:, rr[k:k + 1], cc[k:k + 1]].T, g[0][:, rr[k:k + 1], cc[k:k + 1]].T, p,
            xp[k:k + 1], yp[k:k + 1], ids=pin.entries[e:e + 1], n_faces=fv.shape[1])
        vals.append(gt[0].numpy())
    vals = np.stack(vals)                                          # [P, T, 3]
    hit = np.abs(vals).sum(2) > 0
    assert (hit.sum(1) <= 1).all() and hit.any()
    idx = hit.argmax(1)
    val = vals[np.arange(len(vals)), idx]
    valid = hit.any(1)
    # the pixels in the kernel's order, 32 a step (the tile's pixels are
    # row-major; those outside the face's bbox add nothing)
    pad = (-len(idx)) % 32
    steps = lambda x, fill: np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)]
                                           ).reshape((-1, 32) + x.shape[1:])
    got = texel_sums_rounds(steps(idx, 0), steps(val, 0.0), steps(valid, False), T)
    assert np.array_equal(got, texel_sums_serial(steps(idx, 0), steps(val, 0.0),
                                                 steps(valid, False), T))
    want = tex_cols[e].numpy()
    assert np.abs(got - want).max() <= ROW_TOL * np.abs(rows.numpy()).max()
