"""The port's SoftRas modules against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go to ``jrender_tpu`` (the oracle,
``backend='jax'``) and to ``jrender_tpu_torch`` with ``device='cpu'``,
where the kernel wrapper takes its plain PyTorch version.

Image tolerances are those of tests/test_softras_pallas.py: rgb atol 2e-5,
alpha and softmax aggregates atol 2e-5 + rtol 1e-4, hard depth atol 1e-5.
Two float32 implementations that round differently agree except at
knife-edge pixels, so each image check holds all pixels but 1% within the
tolerance.  XLA on the CPU contracts a*b + c*d into an FMA inside a fusion
and divides by a constant through its reciprocal, where PyTorch rounds
each operation.  A softmax aggregate moves by one ulp of the normalised
depth times 1/gamma, so it is compared at gamma = 1e-3, as the JAX suite
does, or with rtol 1e-3 at the default gamma = 1e-4.

Rgb has one more kind of knife edge, which the 1% does not count but
which must be explained.  With a soft distance a pixel outside a face
still takes that face's texel colour, and its clipped barycentric point
lies on an edge or a corner, where wc0 + wc1 = 1 puts the texel selector
exactly on its diagonal: the rounding decides the texel, in float64 as
in float32 (measured: 1.1-2.3% of the pixels of a 64-px soup).  So a
pixel beyond the tolerance is not counted when the oracle's value lies
within the tolerance of the port's values with that tie broken each way
(``texel_tie_variants``).  At the Renderer's sigma = 1e-5 and gamma =
1e-4 the soft coverage and the depth weights amplify rounding a
hundred-thousand-fold, so a pixel is also not counted where the port's
own float32 rounding, read against a float64 evaluation of the same plain
version, is at least a quarter of the difference (``ROUNDING_SHARE``).
Pixels explained neither way are held to the 1% (measured worst: 0.37%
of a soup here, 0.39% of a rendered sphere).  The soups here are well-shaped
triangles: a sliver face makes float32 barycentrics ill-conditioned in
both packages alike (the renderer tests on the UV sphere cover those).
"""
import math
import subprocess
import sys
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import binning as jbin
from jrender_tpu.ops.softras import geometry as jgeo
from jrender_tpu.ops.softras import jax_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import binning, cuda_impl, torch_impl
from jrender_tpu_torch.ops.softras import geometry as tgeo
from jrender_tpu_torch.ops.softras import make_params, soft_rasterize
from jrender_tpu_torch.ops.softras.api import soft_rasterize_with_aux
from jrender_tpu_torch.utils.checks import fold_ties, grad_beyond, tie_symmetric

from conftest import make_random_mesh

torch.set_num_threads(2)

RGB_ATOL = 2e-5
ATOL = 2e-5
RTOL = 1e-4
DEPTH_ATOL = 1e-5
# a pixel's difference is the port's rounding when the port's own float32
# error there (against float64) is at least this share of it
ROUNDING_SHARE = 0.25
TIE_SHIFT = 1e-4                 # relative move of the texel selector's input


def assert_close_except_edges(actual, expected, atol, rtol=0.0, frac=0.01,
                              pixel_axis=None):
    """All but ``frac`` of the pixels within atol + rtol*|expected|.  With
    ``pixel_axis`` the channels on that axis count as one pixel."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    bad = np.abs(actual - expected) > atol + rtol * np.abs(expected)
    if pixel_axis is not None:
        bad = bad.any(axis=pixel_axis)
    assert np.isfinite(actual).all()
    assert bad.mean() <= frac, \
        f'{bad.mean():.4f} of pixels beyond tolerance (allowed {frac}); ' \
        f'max diff {np.abs(actual - expected).max():.3g}'


def assert_rgb_close(actual, expected, variants, exact, atol=RGB_ATOL, frac=0.01,
                     pixel_axis=1):
    """All rgb pixels within atol, except knife-edge pixels (see the module
    docstring) and at most ``frac`` of the pixels besides.  ``variants``
    [V, ...]: the port's rgb with the texel diagonal tie broken each way;
    ``exact``: the port's plain version in float64 on the same inputs."""
    actual, expected, exact = (np.asarray(a, np.float64) for a in (actual, expected, exact))
    variants = np.asarray(variants, np.float64)
    assert np.isfinite(actual).all()
    diff = np.abs(actual - expected).max(axis=pixel_axis)
    bad = diff > atol
    lo = np.minimum(actual, variants.min(0)) - atol
    hi = np.maximum(actual, variants.max(0)) + atol
    tie = ((expected >= lo) & (expected <= hi)).all(axis=pixel_axis)
    rounding = np.abs(actual - exact).max(axis=pixel_axis) >= ROUNDING_SHARE * diff
    unexplained = bad & ~tie & ~rounding
    assert unexplained.mean() <= frac, \
        f'{unexplained.mean():.4f} of pixels beyond tolerance and not knife edges ' \
        f'(allowed {frac}); max diff there {np.where(unexplained, diff, 0).max():.3g}'


def texel_tie_variants(fn):
    """fn() with the port's own texel selector fed the clipped barycentrics
    scaled by 1 - TIE_SHIFT, then by 1 + TIE_SHIFT: a pair within about
    TIE_SHIFT * R of the diagonal takes the lower, then the upper texel,
    and a pair elsewhere keeps its texel unless it lies as close to a texel
    border.  Returns the two results stacked."""
    select = tgeo.sample_texture_surface_idx
    outs = []
    for shift in (-TIE_SHIFT, TIE_SHIFT):
        def shifted(w_clip, texture_res, scale=1.0 + shift):
            return select(w_clip * scale, texture_res)
        with mock.patch.object(tgeo, 'sample_texture_surface_idx', shifted):
            outs.append(np.asarray(fn()))
    return np.stack(outs)


def run_both(fv, tex, **kw):
    """JAX oracle and port plain version on the same inputs, as numpy:
    (image, aggrs) of each, then the port's texel-tie variants and its
    float64 image for ``assert_rgb_close``."""
    pj, pt = jax_params(**kw), make_params(**kw)
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex), pj)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    ot, at, _ = torch_impl.soft_rasterize_fwd_plain(fvt, text, pt)
    ties = texel_tie_variants(lambda: torch_impl.soft_rasterize_fwd_plain(fvt, text, pt)[0])
    exact = torch_impl.soft_rasterize_fwd_plain(fvt.double(), text.double(), pt)[0]
    return np.asarray(oj), np.asarray(aj), ot.numpy(), at.numpy(), ties, exact.numpy()


def soup(rng, F=24, B=1, T=4, centre=(-0.7, 0.7), radius=(0.15, 0.35)):
    """Random well-shaped triangles in front of the camera: corners at
    angles 120 degrees apart, jittered, so no face is a sliver."""
    c = rng.uniform(*centre, (B, F, 1, 2))
    r = rng.uniform(*radius, (B, F, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
        + rng.uniform(-0.3, 0.3, (B, F, 3))
    xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    z = 2.5 + rng.uniform(-0.4, 0.4, (B, F, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32)
    tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
    return fv.reshape(B, F, 9), tex


def check_images(oj, aj, ot, at, ties, exact, softmax=True, aggr_rtol=RTOL):
    assert_rgb_close(ot[:, :3], oj[:, :3], ties[:, :, :3], exact[:, :3])
    assert_close_except_edges(ot[:, 3], oj[:, 3], ATOL, RTOL)
    if softmax:
        assert_close_except_edges(at, aj, ATOL, aggr_rtol, pixel_axis=1)
    else:
        assert_close_except_edges(at[:, 0], aj[:, 0], DEPTH_ATOL)
        assert_close_except_edges(at[:, 1], aj[:, 1], 0)


# --------------------------------------------------------------------------
# params and geometry
# --------------------------------------------------------------------------

def test_params_match():
    import dataclasses
    kw = dict(image_size=48, dist_eps=1e-3, sigma_val=2e-4, aggr_func_rgb='hard')
    assert dataclasses.asdict(make_params(**kw)) == \
        dataclasses.asdict(jax_params(**kw))
    p = make_params(**kw)
    assert p.threshold == jax_params(**kw).threshold
    assert math.isclose(p.dist_eps, math.log(1 / 1e-3 - 1))


def test_face_info_preprocess(rng):
    face = make_random_mesh(rng, num_faces=64).reshape(64, 9)
    face[5] = face[4]                           # degenerate: det clamped
    ji, js, jo = jgeo.face_info_preprocess(jnp.asarray(face))
    ti, ts, to = tgeo.face_info_preprocess(torch.tensor(face))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.sum(-1).max() <= 1                # at most the first obtuse corner
    assert np.isfinite(ti.numpy()).all()


def _pairs(rng, n_faces=32, n_px=256):
    face = make_random_mesh(rng, num_faces=n_faces).reshape(n_faces, 9)
    xp = rng.uniform(-1, 1, n_px).astype(np.float32)
    yp = rng.uniform(-1, 1, n_px).astype(np.float32)
    return face, xp, yp


@pytest.mark.parametrize('fn', ['barycentric', 'border', 'frontside', 'clip_depth',
                                'barycentric_distance', 'euclidean', 'texel'])
def test_geometry_pairs(fn, rng):
    face, xp, yp = _pairs(rng)
    fj, ft = jnp.asarray(face), torch.tensor(face)
    xj, yj = jnp.asarray(xp)[:, None], jnp.asarray(yp)[:, None]
    xt, yt = torch.tensor(xp)[:, None], torch.tensor(yp)[:, None]
    ij, sj, oj = jgeo.face_info_preprocess(fj)
    it, st, ot = tgeo.face_info_preprocess(ft)
    wj = jgeo.barycentric_coordinate(ij[None], xj, yj)
    wt = tgeo.barycentric_coordinate(it[None], xt, yt)
    # w itself is ill-conditioned on slivers: compare the rest on a
    # common w so that each function is checked on its own
    w = torch.tensor(np.asarray(wj))
    if fn == 'barycentric':
        # a rounding of inv*x is an ulp of |inv|: compare relative to it
        scale = np.abs(it.numpy()).max(-1)[None, :, None]
        np.testing.assert_allclose(wt.numpy() / scale, np.asarray(wj) / scale, atol=1e-6)
    elif fn == 'border':
        thr = 0.01
        np.testing.assert_array_equal(
            tgeo.check_border_outside(xt, yt, ft[None], thr).numpy(),
            np.asarray(jgeo.check_border_outside(xj, yj, fj[None], thr)))
    elif fn == 'frontside':
        np.testing.assert_array_equal(tgeo.check_face_frontside(ft).numpy(),
                                      np.asarray(jgeo.check_face_frontside(fj)))
    elif fn == 'clip_depth':
        wcj = jgeo.barycentric_clip(jnp.asarray(w.numpy()))
        wct = tgeo.barycentric_clip(w)
        np.testing.assert_allclose(wct.numpy(), np.asarray(wcj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tgeo.perspective_depth(wct, ft[None]).numpy(),
                                   np.asarray(jgeo.perspective_depth(wcj, fj[None])),
                                   rtol=1e-6)
    elif fn == 'barycentric_distance':
        np.testing.assert_allclose(tgeo.barycentric_distance(w).numpy(),
                                   np.asarray(jgeo.barycentric_distance(jnp.asarray(w.numpy()))),
                                   rtol=1e-6)
    elif fn == 'euclidean':
        sj_, dxj, dyj, tj = jgeo.euclidean_p2f_distance(
            jnp.asarray(w.numpy()), fj[None], sj[None], oj[None], xj, yj)
        st_, dxt, dyt, tt = tgeo.euclidean_p2f_distance(
            w, ft[None], st[None], ot[None], xt, yt)
        np.testing.assert_array_equal(st_.numpy(), np.asarray(sj_))
        disj = np.asarray(dxj) ** 2 + np.asarray(dyj) ** 2
        dist = dxt.numpy() ** 2 + dyt.numpy() ** 2
        assert_close_except_edges(np.sqrt(dist), np.sqrt(disj), atol=1e-5, frac=0.002)
    else:
        wcj = jgeo.barycentric_clip(jnp.asarray(w.numpy()))
        wct = torch.tensor(np.asarray(wcj))
        for R in (1, 2, 5):
            np.testing.assert_array_equal(
                tgeo.sample_texture_surface_idx(wct, R).numpy(),
                np.asarray(jgeo.sample_texture_surface_idx(wcj, R)))


def test_pixel_grid():
    for is_ in (32, 40, 64):
        xj, yj = jax_impl.pixel_grid(is_)
        xt, yt = torch_impl.pixel_grid(is_)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------

def _with_big_faces(rng, F):
    fv = make_random_mesh(rng, num_faces=F, scale=0.8).reshape(1, F, 9)
    # a few faces spanning most of the screen: the big-face list
    fv[0, :3, 0::3] = [[-0.9, 0.9, 0.0], [-0.8, 0.7, -0.9], [0.9, -0.9, 0.2]]
    fv[0, :3, 1::3] = [[-0.9, -0.8, 0.9], [0.8, 0.9, -0.7], [0.9, 0.8, -0.9]]
    return fv


@pytest.mark.parametrize('F,is_,mt', [(300, 64, 128), (300, 64, 4), (120, 48, 6)])
def test_binning_matches_jax(F, is_, mt, rng):
    fv = _with_big_faces(rng, F)
    thr = make_params(image_size=is_).threshold
    jl = jbin.build_tile_lists_compact(jnp.asarray(fv), is_, 16, 16, thr, mt)
    tl = binning.build_tile_lists_compact(torch.tensor(fv), is_, 16, 16, thr, mt)
    np.testing.assert_array_equal(tl.counts.numpy(), np.asarray(jl.counts))
    np.testing.assert_array_equal(tl.starts.numpy(), np.asarray(jl.starts))
    gc = int(jl.gcount[0])
    assert int(tl.gcount[0]) == gc
    np.testing.assert_array_equal(tl.glist[0, :gc].numpy(), np.asarray(jl.glist)[0, :gc])
    if mt == 4:
        assert gc > 0
    # every tile's list, as the kernel walks it, against the JAX lists
    NT = (is_ // 16) ** 2
    fs = np.asarray(jl.faces_sorted)[0]
    st = np.asarray(jl.starts)[0]
    gt = np.asarray(jl.gt_cum)[0, :, -1]
    gl = np.asarray(jl.glist)[0]
    gcum = np.asarray(jl.gt_cum)[0]
    for t in range(NT):
        n_run = int(jl.counts[0, t]) - int(gt[t])
        big = [int(gl[g]) for g in range(gc) if gcum[t, g] > (gcum[t, g - 1] if g else 0)]
        expect = big + fs[st[t]:st[t] + n_run].tolist()
        got = binning.tile_list(tl, 0, t, is_ // 16).tolist()
        assert got == expect, f'tile {t}'


def test_binning_keeps_every_face_and_reports_nothing(rng):
    fv = _with_big_faces(rng, 200)
    thr = make_params(image_size=32).threshold
    tl = binning.build_tile_lists_compact(torch.tensor(fv), 32, 16, 16, thr, 2)
    assert tl.glist.shape[1] == 200            # room for every face
    # every face on screen is listed: in a tile's run or in the big-face list
    on_screen = ~binning.pixel_ranges(torch.tensor(fv), 32, thr)[4][0]
    listed = set(tl.faces_sorted[0, :int(tl.run_counts.sum())].tolist()) \
        | set(tl.glist[0, :int(tl.gcount[0])].tolist())
    assert listed == set(torch.nonzero(on_screen)[:, 0].tolist())
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        binning.report_overflow(tl)


def test_binning_drops_only_faces_off_screen(rng):
    """A face whose projection overflows (near the eye plane) or is NaN
    bins nowhere; the int casts cannot wrap into a tile."""
    fv, _ = soup(rng, F=6)
    fv[0, 1, 0::3] = [1e12, 2e12, 3e12]          # far off screen to the right
    fv[0, 2, :] = np.nan
    fv[0, 3, 0::3] = [-1e12, 1e12, 0.0]          # spans the whole screen: big
    fv[0, 3, 1::3] = [-1e12, 0.0, 1e12]
    thr = make_params(image_size=32).threshold
    tl = binning.build_tile_lists_compact(torch.tensor(fv), 32, 16, 16, thr, 3)
    listed = set(tl.faces_sorted[0, :int(tl.run_counts.sum())].tolist())
    assert 1 not in listed and 2 not in listed
    assert tl.glist[0, :int(tl.gcount[0])].tolist() == [3]
    assert int(tl.counts.min()) >= 1             # the big face reaches every tile


def test_binning_ragged_edge(rng):
    """Sizes not divisible by the tile get a partial last tile row/column."""
    fv = make_random_mesh(rng, num_faces=40, scale=0.95).reshape(1, 40, 9)
    thr = make_params(image_size=40).threshold
    tl = binning.build_tile_lists_compact(torch.tensor(fv), 40, 16, 16, thr)
    assert tl.counts.shape == (1, 9)
    assert int(tl.counts[0].reshape(3, 3)[2].sum() + tl.counts[0].reshape(3, 3)[:, 2].sum()) > 0


# --------------------------------------------------------------------------
# forward: the plain version against the JAX oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize('dist_func', ['hard', 'barycentric', 'euclidean'])
@pytest.mark.parametrize('rgb_func', ['hard', 'softmax'])
@pytest.mark.parametrize('alpha_func', ['hard', 'sum', 'prod'])
def test_forward_configs(dist_func, rgb_func, alpha_func, rng):
    fv, tex = soup(rng, F=48, T=25)
    kw = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3, dist_func=dist_func,
              aggr_func_rgb=rgb_func, aggr_func_alpha=alpha_func)
    check_images(*run_both(fv, tex, **kw), softmax=rgb_func == 'softmax')


@pytest.mark.parametrize('T', [1, 4, 25, 'vertex'])
def test_forward_textures(T, rng):
    vertex = T == 'vertex'
    fv, tex = soup(rng, F=48, T=3 if vertex else T)
    kw = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3,
              texture_type='vertex' if vertex else 'surface')
    check_images(*run_both(fv, tex, **kw))


def test_forward_defaults_and_background(rng):
    """The Renderer's own sigma and gamma, a coloured background and the
    back faces dropped (fill_back=False gates rgb on the front side)."""
    fv, tex = soup(rng, F=48, T=25)
    kw = dict(image_size=64, background_color=(0.2, 0.4, 0.6), fill_back=False)
    oj, aj, ot, at, ties, exact = run_both(fv, tex, **kw)
    check_images(oj, aj, ot, at, ties, exact, aggr_rtol=1e-3)
    # uncovered pixels are the background
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)[:, None]
    far = ot[0, 3] == 0
    assert far.any()
    np.testing.assert_allclose(ot[0, :3][:, far], np.broadcast_to(bg, (3, far.sum())),
                               atol=1e-6)


def test_forward_batched(rng):
    fv, tex = soup(rng, F=32, B=2, T=4)
    kw = dict(image_size=48, sigma_val=1e-3, gamma_val=1e-3)
    out = run_both(fv, tex, **kw)
    assert out[2].shape == (2, 4, 48, 48)
    check_images(*out)


def test_forward_pixel_subset(rng):
    """forward_single takes any list of pixel centres: a subset gives the
    full image's values at those pixels."""
    fv, tex = soup(rng, F=24)
    p = make_params(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    full, ag, cnt = torch_impl.soft_rasterize_fwd_plain(torch.tensor(fv), torch.tensor(tex), p)
    idx = torch.tensor(rng.choice(32 * 32, 100, replace=False))
    xp, yp = torch_impl.pixel_centers(idx // 32, idx % 32, 32)
    col, agp, cntp = torch_impl.forward_pixels(torch.tensor(fv), torch.tensor(tex), p,
                                               xp, yp, chunk_pairs=300)
    np.testing.assert_array_equal(col[0].numpy(), full[0].reshape(4, -1)[:, idx].T.numpy())
    np.testing.assert_array_equal(cntp[0].numpy(), cnt[0].reshape(-1)[idx].numpy())


def test_dense_tile_keeps_every_face(rng):
    """2,100 small faces over one 16-px tile: past the JAX pxt cap of 2,048
    faces per tile.  The port keeps them all; it matches the oracle.  One
    texel per face: with hundreds of candidates per pixel, texel-diagonal
    flips would touch most pixels of the tile."""
    F = 2100
    # tile (row 0, col 0) at 32 px spans x in [-1, 0) and y in (0, 1]
    fv, tex = soup(rng, F=F, T=1, centre=(-0.85, -0.15), radius=(0.03, 0.08))
    fv[..., 1::3] *= -1                         # centres to y in (0.15, 0.85)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    thr = make_params(**kw).threshold
    tl = binning.build_tile_lists_compact(torch.tensor(fv), 32, 16, 16, thr)
    assert int(tl.counts.max()) > 2048
    check_images(*run_both(fv, tex, **kw))


# --------------------------------------------------------------------------
# the kernel wrapper and the entry points
# --------------------------------------------------------------------------

def test_wrapper_takes_plain_path_on_cpu(rng):
    fv, tex = soup(rng, F=24)
    p = make_params(image_size=32)
    before = cuda_impl.launch.launches
    got = cuda_impl.soft_rasterize_fwd(torch.tensor(fv), torch.tensor(tex), p)
    want = torch_impl.soft_rasterize_fwd_plain(torch.tensor(fv), torch.tensor(tex), p)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cuda_impl.launch.launches == before


def test_launch_refuses_cpu_tensors(rng):
    fv, tex = soup(rng, F=8)
    p = make_params(image_size=32)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_impl.launch(cuda_impl.prepare(torch.tensor(fv), torch.tensor(tex), p), p)


def test_face_rows_layout(rng):
    fv, tex = soup(rng, F=8, T=25)
    p = make_params(image_size=32)
    rows = cuda_impl.face_rows(torch.tensor(fv), torch.tensor(tex), p)
    assert rows.shape == (1, 8, 31 + 75) and rows.is_contiguous()
    inv, sym, obt = tgeo.face_info_preprocess(torch.tensor(fv))
    torch.testing.assert_close(rows[..., 9:18], inv)
    torch.testing.assert_close(rows[..., 18:27], sym)
    torch.testing.assert_close(rows[..., 27:30], obt)
    torch.testing.assert_close(rows[..., 31:], torch.tensor(tex).reshape(1, 8, 75))
    assert cuda_impl.chunk_for(rows.shape[-1]) * (4 * rows.shape[-1] + 4) <= cuda_impl.SMEM_BYTES


def test_soft_rasterize_entry(rng):
    fv, tex = soup(rng, F=24)
    img = soft_rasterize(fv.reshape(1, 24, 3, 3), tex, image_size=32, sigma_val=1e-3,
                         device='cpu')
    p = make_params(image_size=32, sigma_val=1e-3)
    want, ag, cnt = torch_impl.soft_rasterize_fwd_plain(torch.tensor(fv), torch.tensor(tex), p)
    torch.testing.assert_close(img, want, rtol=0, atol=0)
    out, ag2, cnt2 = soft_rasterize_with_aux(fv, tex, p, device='cpu')
    torch.testing.assert_close(ag2, ag, rtol=0, atol=0)
    assert cnt2.dtype == torch.int32


# --------------------------------------------------------------------------
# backward: top-K, the plain version against the JAX oracle, autograd
# --------------------------------------------------------------------------
#
# Gradient tolerance: atol = 2e-3 * max|grad| and rtol = 2e-3, that of
# tests/test_softras_pallas.py:126-128.  With more than one texel per face
# the diagonal tie of the texel selector (module docstring) moves gradient
# between texel i and texel T-1-i and, through the colour, changes the face
# gradient.  So the textures of these tests are equal on the two sides of
# the tie (``tie_symmetric``), which makes the face gradient independent of
# it, and texture gradients are compared folded over each tie pair
# (``fold_ties``); one test with generic textures compares the per-face
# totals, as the JAX suite does.


def assert_grad_close(actual, expected, frac=0.0):
    share, err = grad_beyond(np.asarray(actual), np.asarray(expected))
    assert share <= frac, \
        f'{share:.4f} of entries beyond tolerance (allowed {frac}); ' \
        f'max diff {err:.3g} of max|expected|'


def grads_both(fv, tex, g, K_oracle=None, **kw):
    """(grad_face, grad_tex) of the JAX oracle's backward and of the port's
    plain backward on the same inputs and incoming gradient g, each on its
    own forward.  ``K_oracle`` gives the oracle another K than the port."""
    pt = make_params(**kw)
    pj = jax_params(**{**kw, 'grad_mode': 'topk', **(
        {} if K_oracle is None else {'max_faces_per_pixel_for_grad': K_oracle})})
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    ot, at, _ = torch_impl.soft_rasterize_fwd_plain(fvt, text, pt)
    thr = cuda_impl.topk_threshold(fvt, pt)
    gft, gtt = cuda_impl.soft_rasterize_bwd(fvt, text, ot, at, thr, torch.tensor(g), pt)
    return np.asarray(gfj), np.asarray(gtj), gft.numpy(), gtt.numpy()


def check_grads(gfj, gtj, gft, gtt, surface=True):
    assert_grad_close(gft, gfj)
    if surface:
        assert_grad_close(fold_ties(gtt), fold_ties(gtj))
    else:
        assert_grad_close(gtt, gtj)


@pytest.mark.parametrize('K', [1, 4, 16, 64])
def test_topk_threshold_and_face_ids(K, rng):
    """topk_face_ids is the oracle's third output; topk_threshold is the
    depth of the last of those ids where the pixel has more than K
    candidates, and far elsewhere."""
    F, is_ = 48, 32
    fv, tex = soup(rng, F=F, T=1)
    kw = dict(image_size=is_, sigma_val=1e-3, max_faces_per_pixel_for_grad=K)
    _, _, ids_j = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                  jax_params(**kw))
    p = make_params(**kw)
    fvt = torch.tensor(fv)
    xp, yp = torch_impl.pixel_grid(is_)
    ids = torch_impl.topk_face_ids(fvt, p, xp, yp, chunk_pairs=5000)
    assert ids.shape == (1, is_ * is_, K)
    ids_j = np.asarray(ids_j).reshape(1, K, -1).transpose(0, 2, 1)
    # two roundings of one depth can order a near-tie differently
    assert (ids.numpy() != ids_j).any(axis=-1).mean() <= 0.002
    thr = torch_impl.topk_threshold(fvt, p, xp, yp, chunk_pairs=5000)[0]
    _, _, counts = torch_impl.soft_rasterize_fwd_plain(fvt, torch.tensor(tex), p)
    counts = counts.reshape(-1)
    assert (thr[counts <= K] == p.far).all()
    if K >= F:
        assert not torch_impl.use_threshold(p, F)
        return
    over = counts > K
    assert over.any() == (K < 16)
    depth = torch_impl._candidate_depths(fvt[0], p, xp, yp)
    kth = depth.gather(1, ids[0, :, K - 1:K].clamp_min(0))[:, 0]
    torch.testing.assert_close(thr[over], kth[over], rtol=0, atol=0)
    # no ties here: exactly K candidates lie within the threshold
    assert ((depth <= thr[:, None]).sum(1)[over] == K).all()


@pytest.mark.parametrize('dist_func', ['hard', 'barycentric', 'euclidean'])
@pytest.mark.parametrize('rgb_func', ['hard', 'softmax'])
@pytest.mark.parametrize('alpha_func', ['hard', 'sum', 'prod'])
def test_backward_configs(dist_func, rgb_func, alpha_func, rng):
    fv, tex = soup(rng, F=48, T=4)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    check_grads(*grads_both(fv, tie_symmetric(tex), g, image_size=32, sigma_val=1e-3,
                            gamma_val=1e-3, dist_func=dist_func, aggr_func_rgb=rgb_func,
                            aggr_func_alpha=alpha_func))


@pytest.mark.parametrize('T', [1, 4, 'vertex'])
@pytest.mark.parametrize('K', [4, 16])
def test_backward_textures_batched(T, K, rng):
    """B = 2, one and four texels and vertex colours, with K = 4 binding
    at most covered pixels and K = 16 at few."""
    vertex = T == 'vertex'
    fv, tex = soup(rng, F=48, B=2, T=3 if vertex else T)
    tex = tex if vertex else tie_symmetric(tex)
    g = rng.randn(2, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3,
              texture_type='vertex' if vertex else 'surface',
              max_faces_per_pixel_for_grad=K)
    if K == 4:
        counts = torch_impl.soft_rasterize_fwd_plain(torch.tensor(fv), torch.tensor(tex),
                                                     make_params(**kw))[2]
        assert (counts > K).float().mean() > 0.1          # the truncation binds
    check_grads(*grads_both(fv, tex, g, **kw), surface=not vertex)


def test_backward_fill_back_off_has_no_side_check(rng):
    """The backward's rgb chain has no front-side check: a back face that
    the forward left out of the softmax still gets gradient.  gamma keeps
    exp((zpn - M) / gamma) of a lone back face within float32."""
    fv, tex = soup(rng, F=48, T=1)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    gfj, gtj, gft, gtt = grads_both(fv, tex, g, image_size=32, sigma_val=1e-3,
                                    gamma_val=0.1, fill_back=False)
    check_grads(gfj, gtj, gft, gtt)
    back = ~tgeo.check_face_frontside(torch.tensor(fv))[0].numpy()
    assert back.any() and np.abs(gtt[0, back]).max() > 0


def test_backward_full_matches_oracle_at_K_equals_F(rng):
    """The oracle ignores grad_mode and always truncates to K; the port's
    'full' sends gradient to every candidate: the oracle's K = F."""
    F = 48
    fv, tex = soup(rng, F=F, T=1)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3,
              max_faces_per_pixel_for_grad=2, grad_mode='full')
    gfj, gtj, gft, gtt = grads_both(fv, tex, g, K_oracle=F, **kw)
    check_grads(gfj, gtj, gft, gtt)
    # and it is not the truncated gradient
    gft_topk = grads_both(fv, tex, g, **{**kw, 'grad_mode': 'topk'})[2]
    assert np.abs(gft_topk - gft).max() > 0.05 * np.abs(gft).max()


def test_backward_generic_textures_face_totals(rng):
    """Generic textures with four texels: a tie flip moves gradient between
    texels of a face, so the per-face totals are compared, as
    tests/test_softras_pallas.py:129-144 does."""
    fv, tex = soup(rng, F=48, T=4)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    g[:, :3] = g[:, :1]       # one weight for r, g and b keeps totals flip-invariant
    _, gtj, _, gtt = grads_both(fv, tex, g, image_size=32, sigma_val=1e-3,
                                gamma_val=1e-3, aggr_func_rgb='hard')
    assert_grad_close(gtt.sum(axis=2), gtj.sum(axis=2))


def test_threshold_form_equals_face_id_form(rng):
    """The masked form (zp <= thr, as the kernels compute it) equals the
    oracle's gather by face ids where no candidate depths tie."""
    fv, tex = soup(rng, F=48, T=4)
    p = make_params(image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=4)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    out, ag, _ = torch_impl.soft_rasterize_fwd_plain(fvt, text, p)
    xp, yp = torch_impl.pixel_grid(32)
    g = torch.tensor(rng.randn(1, 32 * 32, 4).astype(np.float32))

    def flat(x):
        return x.reshape(1, x.shape[1], -1).permute(0, 2, 1)

    by_thr = torch_impl.backward_pixels(fvt, text, flat(out), flat(ag), g, p, xp, yp,
                                        thr=torch_impl.topk_threshold(fvt, p, xp, yp))
    by_ids = torch_impl.backward_pixels(fvt, text, flat(out), flat(ag), g, p, xp, yp,
                                        face_ids=torch_impl.topk_face_ids(fvt, p, xp, yp),
                                        chunk_pairs=7000)
    untruncated = torch_impl.backward_pixels(fvt, text, flat(out), flat(ag), g, p, xp, yp)
    for a, b, c in zip(by_thr, by_ids, untruncated):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
        assert (a - c).abs().max() > 0.01 * c.abs().max()


def test_topk_ties_keep_every_tied_face():
    """Where candidate depths tie at the K-th place the two forms differ,
    as the JAX package's oracle and its TPU kernels do: the oracle's stable
    sort keeps the lowest face index, ``zp <= thr`` keeps every tied face.
    Three overlapping faces share the vertex (0, 0, 2), as front and back
    faces do at a silhouette vertex; a pixel beyond the vertex, opposite
    all three, clips to it on each face, so all three have zp = 2 exactly."""
    fan = np.array([[[0, 0, 2, -0.6, 0.1, 2.5, -0.6, 0.5, 3.0],
                     [0, 0, 2, -0.5, 0.0, 3.0, -0.3, 0.6, 2.2],
                     [0, 0, 2, -0.6, 0.3, 2.2, -0.4, 0.6, 2.8]]], np.float32)
    p = make_params(image_size=32, sigma_val=1e-2, max_faces_per_pixel_for_grad=1)
    fvt = torch.tensor(fan)
    xp, yp = torch.tensor([0.15625]), torch.tensor([-0.09375])
    depth = torch_impl._candidate_depths(fvt[0], p, xp, yp)
    assert depth.tolist() == [[2.0, 2.0, 2.0]]
    assert torch_impl.topk_threshold(fvt, p, xp, yp).tolist() == [[2.0]]
    assert torch_impl.topk_face_ids(fvt, p, xp, yp).tolist() == [[[0]]]
    tex = torch.rand(1, 3, 1, 3, generator=torch.Generator().manual_seed(0))
    col, ag, cnt = torch_impl.forward_pixels(fvt, tex, p, xp, yp)
    assert cnt.tolist() == [[3]]
    g = torch.ones(1, 1, 4)
    by_thr = torch_impl.backward_pixels(fvt, tex, col, ag, g, p, xp, yp,
                                        thr=torch_impl.topk_threshold(fvt, p, xp, yp))[0]
    by_ids = torch_impl.backward_pixels(fvt, tex, col, ag, g, p, xp, yp,
                                        face_ids=torch_impl.topk_face_ids(fvt, p, xp, yp))[0]
    moved = lambda gf: (gf[0].abs().sum(dim=1) > 0).tolist()
    assert moved(by_thr) == [True, True, True] and moved(by_ids) == [True, False, False]
    torch.testing.assert_close(by_thr[0, 0], by_ids[0, 0])


def test_backward_pixel_subset_and_float64(rng):
    """The gradient is a sum over pixels: the backward of a subset of the
    pixels equals the full backward of a gradient that is zero elsewhere;
    float64 inputs give a float64 gradient that the float32 one matches."""
    fv, tex = soup(rng, F=24, T=1)
    p = make_params(image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=4)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    out, ag, _ = torch_impl.soft_rasterize_fwd_plain(fvt, text, p)
    thr = torch_impl.topk_threshold_plain(fvt, p)
    idx = torch.tensor(rng.choice(32 * 32, 200, replace=False))
    g = torch.zeros(1, 4, 32 * 32)
    g[:, :, idx] = torch.tensor(rng.randn(1, 4, 200).astype(np.float32))
    full = torch_impl.soft_rasterize_bwd_plain(fvt, text, out, ag, thr, g.reshape(1, 4, 32, 32), p)

    def at(x):
        return x.reshape(1, x.shape[1], -1)[:, :, idx].permute(0, 2, 1)

    xp, yp = torch_impl.pixel_centers(idx // 32, idx % 32, 32)
    sub = torch_impl.backward_pixels(fvt, text, at(out), at(ag), at(g), p, xp, yp,
                                     thr=thr.reshape(1, -1)[:, idx], chunk_pairs=1000)
    # the threshold is a depth of the same arithmetic: float64 depths take
    # a float64 threshold, or the K-th candidate falls out at half the pixels
    exact = torch_impl.backward_pixels(fvt.double(), text.double(), at(out).double(),
                                       at(ag).double(), at(g).double(), p, xp, yp,
                                       thr=torch_impl.topk_threshold(fvt.double(), p, xp, yp))
    for a, b, c in zip(full, sub, exact):
        assert c.dtype == torch.float64
        assert_grad_close(b.numpy(), a.numpy())
        assert_grad_close(b.numpy(), c.numpy())


@pytest.mark.parametrize('kw', [dict(), dict(max_faces_per_pixel_for_grad=4),
                                dict(grad_mode='full'),
                                dict(texture_type='vertex', aggr_func_alpha='sum')],
                         ids=['default', 'K4', 'full', 'vertex-sum'])
def test_soft_rasterize_grad_matches_jax_grad(kw, rng):
    """``soft_rasterize(...)`` under autograd against ``jax.grad`` of the
    JAX package's ``soft_rasterize`` with backend='jax'."""
    import jax
    from jrender_tpu.ops.softras import soft_rasterize as jax_soft_rasterize
    vertex = kw.get('texture_type') == 'vertex'
    F = 40
    fv, tex = soup(rng, F=F, B=2, T=3 if vertex else 1)
    g = rng.randn(2, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, **kw)
    # the oracle has no 'full': it is its K = F
    kwj = {**kw, 'grad_mode': 'topk', 'max_faces_per_pixel_for_grad': F} \
        if kw.get('grad_mode') == 'full' else kw

    def loss_j(f, t):
        return jnp.sum(jax_soft_rasterize(f, t, backend='jax', **kwj) * g)

    gfj, gtj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(fv), jnp.asarray(tex))
    x = torch.tensor(fv.reshape(2, F, 3, 3), requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    img = soft_rasterize(x, t, device='cpu', **kw)
    (img * torch.tensor(g)).sum().backward()
    assert x.grad.shape == (2, F, 3, 3) and t.grad.shape == tex.shape
    assert_grad_close(x.grad.reshape(2, F, 9).numpy(), np.asarray(gfj))
    assert_grad_close(t.grad.numpy(), np.asarray(gtj))


def test_backward_honours_needs_input_grad(rng, monkeypatch):
    """Only what requires a gradient gets one; a forward that no backward
    can follow computes no threshold."""
    fv, tex = soup(rng, F=24)
    calls = []
    plain = torch_impl.topk_threshold_plain
    monkeypatch.setattr(torch_impl, 'topk_threshold_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    kw = dict(image_size=16, sigma_val=1e-3, max_faces_per_pixel_for_grad=2, device='cpu')
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    soft_rasterize(fv, tex, **kw)                       # nothing requires grad
    with torch.no_grad():
        soft_rasterize(x, t, **kw)
    soft_rasterize(x, t, grad_mode='full', **{k: v for k, v in kw.items()})
    assert not calls
    soft_rasterize(x.detach(), t, **kw).sum().backward()
    assert len(calls) == 1
    assert x.grad is None and t.grad is not None and t.grad.abs().max() > 0
    soft_rasterize(x, t.detach(), **kw)[:, 3].sum().backward()   # a slice: not contiguous
    assert len(calls) == 2 and x.grad is not None and torch.isfinite(x.grad).all()


def test_binning_inverse_map(rng):
    """gsrc sends each emitted (face, tile) pair to its place in the sorted
    run and gpos each big face to its place in the big-face list."""
    fv = torch.tensor(_with_big_faces(rng, 120))
    thr = make_params(image_size=64).threshold
    tl = binning.build_tile_lists_compact(fv, 64, 16, 16, thr, 4, with_inverse=True)
    plain = binning.build_tile_lists_compact(fv, 64, 16, 16, thr, 4)
    assert plain.gsrc is None and plain.gpos is None
    for a, b in zip(tl[:7], plain[:7]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gsrc, gpos = tl.gsrc[0], tl.gpos[0]
    assert gsrc.shape == (120, 4) and gsrc.dtype == torch.int32
    valid = gsrc >= 0
    assert int(valid.sum()) == int(tl.run_counts.sum())
    face_of = torch.arange(120)[:, None].expand(-1, 4)
    assert (tl.faces_sorted[0][gsrc[valid].long()] == face_of[valid]).all()
    assert gsrc[valid].unique().numel() == int(valid.sum())      # one place each
    # ascending j is ascending place: a face's tiles in ascending order
    later = torch.where(valid, gsrc, torch.iinfo(torch.int32).max)
    assert (later[:, 1:] >= later[:, :-1]).all()
    gc = int(tl.gcount[0])
    assert gc > 0
    big = gpos >= 0
    assert int(big.sum()) == gc and not valid[big].any()
    assert (tl.glist[0][gpos[big].long()] == torch.arange(120)[big]).all()


def test_reduce_rows_plain_is_a_segment_sum(rng):
    """The plain face reduction against index_add_ of the rows by face id;
    rows of pairs that were not emitted hold anything and are not read."""
    fv, tex = soup(rng, F=60, B=2, T=1)
    p = make_params(image_size=64)
    inputs = cuda_impl.prepare(torch.tensor(fv), torch.tensor(tex), p, for_grad=True)
    # an emit cap of 3 tiles per face: what spans more is a big face
    cl = binning.build_tile_lists_compact(torch.tensor(fv), 64, cuda_impl.TILE, cuda_impl.TILE,
                                          p.threshold, 3, with_inverse=True)
    inputs = inputs._replace(lists=cl)
    B, F, L, GC = 2, 60, cl.faces_sorted.shape[1], 12
    gslots = torch.tensor(rng.randn(B, L, GC).astype(np.float32))
    gbig = torch.tensor(rng.randn(B, F, GC).astype(np.float32))
    n_valid = cl.run_counts.sum(dim=1)
    assert int(cl.gcount.min()) > 0
    want = torch.zeros(B, F, GC)
    for b in range(B):
        n = int(n_valid[b])
        want[b].index_add_(0, cl.faces_sorted[b, :n].long(), gslots[b, :n])
        gslots[b, n:] = float('nan')
        g = int(cl.gcount[b])
        want[b, cl.glist[b, :g].long()] = gbig[b, :g]
        gbig[b, g:] = float('nan')
    gf, gt = cuda_impl.reduce_rows_plain(inputs, cuda_impl.GradRows(gslots, gbig), p)
    assert gf.shape == (B, F, 9) and gt.shape == (B, F, 1, 3)
    torch.testing.assert_close(torch.cat([gf, gt.reshape(B, F, 3)], -1), want,
                               rtol=1e-5, atol=1e-5)


def test_backward_wrappers_refuse_cpu_tensors(rng):
    fv, tex = soup(rng, F=8)
    p = make_params(image_size=32)
    inputs = cuda_impl.prepare(torch.tensor(fv), torch.tensor(tex), p, for_grad=True)
    img, ag, counts = torch_impl.soft_rasterize_fwd_plain(torch.tensor(fv), torch.tensor(tex), p)
    before = [w.launches for w in (cuda_impl.launch_thr, cuda_impl.launch_bwd,
                                   cuda_impl.launch_reduce)]
    with pytest.raises(ValueError, match='CUDA'):
        cuda_impl.launch_thr(inputs, counts, p)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_impl.launch_bwd(inputs, img, ag, None, torch.ones_like(img), p)
    rows = cuda_impl.GradRows(torch.zeros(1, inputs.lists.faces_sorted.shape[1], 21),
                              torch.zeros(1, 8, 21))
    with pytest.raises(ValueError, match='CUDA'):
        cuda_impl.launch_reduce(inputs, rows, p)
    assert before == [w.launches for w in (cuda_impl.launch_thr, cuda_impl.launch_bwd,
                                           cuda_impl.launch_reduce)]


def test_no_device_without_card_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    fv, tex = soup(rng, F=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soft_rasterize(fv, tex, image_size=16)
