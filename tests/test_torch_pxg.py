"""The port's pxg route (grouped work items) against the JAX package, on the CPU.

The route is taken where ``JR_LAYOUT=pxg`` and the image size is divisible
by 8; every test sets the variables with ``monkeypatch``, which restores
them, and the JAX side's layout with ``monkeypatch.setattr(pallas_impl,
'LAYOUT', ...)``, so the JAX suite's own routing never sees them.  On the
CPU the pxg wrappers take their plain versions, which read what the
kernels read: the binned route's rows and tile lists, written out tile
after tile and cut into work items of ``group`` faces (``prep_pxg``).  So
these tests hold against the JAX package everything of the route but the
kernel bodies: the routing, the work items, the per-item partials and
their combine, the threshold from the items' depth lists, the entry rows
of the backward and their sum per face.

The JAX side is its pxg layout itself (``pxg_impl.soft_rasterize_fwd_pxg``
/ ``_bwd_pxg`` in interpret mode, as tests/test_softras_pallas.py runs it,
at 32 px: the layout computes pixel centres per tile base, which is exact
only at power-of-two sizes, pxg_impl.py:221-226) in a few cases, and the
oracle (``jax_impl``) on the distance x rgb x alpha sweep.  Tolerances:
against the JAX pxg layout those of its own suite
(tests/test_softras_pallas.py:184-197: images atol 2e-5 on all but 1% of
the pixels, alpha and aggregates atol 5e-4 + rtol 1e-4), counts exact and
the threshold to 1e-6 relative on all but 1% of the pixels where it binds; against the
oracle ``test_torch_softras.py``'s, knife-edge pixels explained;
gradients atol 2e-3 * max|grad|, rtol 2e-3 with tie-symmetric textures.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import api as jax_api
from jrender_tpu.ops.softras import jax_impl, pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params
from jrender_tpu.ops.softras import pxg_impl as jax_pxg

from jrender_tpu_torch.ops import segment_sum
from jrender_tpu_torch.ops.softras import (binning, cuda_impl, dir_impl, make_params,
                                           pxg_impl, route, soft_rasterize, tiled, torch_impl)
from jrender_tpu_torch.ops.softras.api import soft_rasterize_with_aux
from jrender_tpu_torch.utils.checks import fold_ties, tie_symmetric

from conftest import make_random_mesh
from test_torch_softras import (ATOL, RTOL, assert_close_except_edges, assert_grad_close,
                                assert_rgb_close, check_grads, check_images, soup,
                                texel_tie_variants)

torch.set_num_threads(2)


@pytest.fixture
def pxg_on(monkeypatch):
    """The pxg route in both packages."""
    monkeypatch.setenv('JR_LAYOUT', 'pxg')
    monkeypatch.setattr(pallas_impl, 'LAYOUT', 'pxg')


def port_forward(fv, tex, p, with_thr=False, group=8, dtype=torch.float32):
    """The port's plain pxg forward: (images, aggrs, counts, thr or None)."""
    pin = pxg_impl.prep_pxg(torch.tensor(fv, dtype=dtype), torch.tensor(tex, dtype=dtype), p,
                            group=group)
    return pxg_impl.forward(pin, p, with_thr)


def run_both_pxg(fv, tex, **kw):
    """The JAX oracle and the port's pxg route (``soft_rasterize_with_aux``,
    device='cpu') on the same inputs, as numpy: what ``check_images`` takes,
    and the port's counts."""
    pj, pt = jax_params(**kw), make_params(**kw)
    assert route.route(pt, fv.shape[1], True) == 'pxg'
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex), pj)
    ot, at, ct = soft_rasterize_with_aux(fv, tex, pt, device='cpu')
    ties = texel_tie_variants(lambda: port_forward(fv, tex, pt)[0])
    exact = port_forward(fv, tex, pt, dtype=torch.float64)[0]
    return (np.asarray(oj), np.asarray(aj), ot.numpy(), at.numpy(), ties, exact.numpy()), ct


def grads_both_pxg(fv, tex, g, **kw):
    """The oracle's gradient (fwd + bwd of ``jax_impl``) and the port's
    through ``soft_rasterize(device='cpu')`` under autograd on the pxg
    route, incoming gradient g."""
    pt = make_params(**kw)
    assert route.route(pt, fv.shape[1], True) == 'pxg'
    pj = jax_params(**{**kw, 'grad_mode': 'topk'})
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    return np.asarray(gfj), np.asarray(gtj), x.grad.numpy(), t.grad.numpy()


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

@pytest.mark.parametrize('layout', ['pxt', 'pxg'])
@pytest.mark.parametrize('dir_max', [None, '128'])
def test_route_matches_jax(layout, dir_max, monkeypatch):
    """route.route equals ``_pallas_route`` mapped to the port's routes
    ('pxt', 'jax' and 'f_px' are served binned), over layouts, sizes, face
    counts around JR_DIR_MAX and the truncation."""
    monkeypatch.setattr(pallas_impl, 'LAYOUT', layout)
    monkeypatch.setenv('JR_LAYOUT', layout)
    if dir_max is None:
        monkeypatch.delenv('JR_DIR_MAX', raising=False)
    else:
        monkeypatch.setenv('JR_DIR_MAX', dir_max)
    mapped = {'dir': 'dir', 'pxg': 'pxg', 'pxt': 'binned', 'jax': 'binned', 'f_px': 'binned'}
    for F in (1, 127, 128, 129, 300):
        for size in (16, 24, 32, 20, 100):
            for kw in (dict(), dict(grad_mode='full'), dict(max_faces_per_pixel_for_grad=400)):
                want = jax_api._pallas_route(jax_params(image_size=size, **kw), F)
                got = route.route(make_params(image_size=size, **kw), F, True)
                assert got == mapped[want], (layout, F, size, kw, want)


@pytest.mark.parametrize('layout', ['px_f', 'f_px', 'pxgg'])
def test_unported_layouts_raise(layout, monkeypatch, rng):
    """No quiet reroute: anything but the four layouts is no layout, and
    the entry points raise before any work.  px_f and f_px were not ported
    when this test was written and raised; they are routes now, so for
    them it checks that the entry points take their route (tests
    test_torch_fpx.py and test_torch_pxf.py hold what they compute)."""
    monkeypatch.setenv('JR_LAYOUT', layout)
    fv, tex = soup(rng, F=8)
    if layout == 'pxgg':
        with pytest.raises(ValueError, match='JR_LAYOUT'):
            route.route(make_params(image_size=32), 8, False)
        with pytest.raises(ValueError):
            soft_rasterize(fv, tex, image_size=32, device='cpu')
        with pytest.raises(ValueError):
            soft_rasterize_with_aux(fv, tex, make_params(image_size=20), device='cpu')
        return
    assert route.route(make_params(image_size=32), 8, False) == layout
    img = soft_rasterize(fv, tex, image_size=32, device='cpu')
    assert img.shape == (1, 4, 32, 32) and torch.isfinite(img).all()
    out = soft_rasterize_with_aux(fv, tex, make_params(image_size=20), device='cpu')
    assert route.route(make_params(image_size=20), 8, False) == 'binned'
    assert out[0].shape == (1, 4, 20, 20)


def test_with_layout_sets_and_restores(monkeypatch):
    monkeypatch.setenv('JR_LAYOUT', 'pxt')
    with route.with_layout('pxg'):
        assert route.layout() == 'pxg'
    assert route.layout() == 'pxt'
    monkeypatch.delenv('JR_LAYOUT')
    with pytest.raises(RuntimeError):
        with route.with_layout('pxg'):
            raise RuntimeError
    assert 'JR_LAYOUT' not in os.environ and route.layout() == 'pxt'


# --------------------------------------------------------------------------
# the work items
# --------------------------------------------------------------------------

@pytest.mark.parametrize('mt', [None, 2])
def test_work_items_cover_the_tile_lists(mt, rng, monkeypatch):
    """Each tile's entries are its binned list (big faces first, then its
    run); the items cut them into groups in order; each face's entries list
    every entry of the face once, in tile order.  An emit cap of 2 tiles
    makes most faces big."""
    if mt is not None:
        monkeypatch.setattr(binning, 'mt_for', lambda F: mt)
    fv, tex = soup(rng, F=60, B=2)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    p = make_params(image_size=72)
    group = 5
    pin = pxg_impl.prep_pxg(fvt, text, p, for_grad=True, group=group)
    lists = cuda_impl.prepare(fvt, text, p).lists
    assert (int(lists.gcount.min()) > 10) == (mt is not None)
    tiles = pxg_impl.tiles_for(72)
    NT = tiles * tiles
    off, ioff = pin.tile_off.long(), pin.item_off.long()
    for b in range(2):
        for t in range(NT):
            g = b * NT + t
            got = pin.entries[off[g]:off[g + 1]]
            assert torch.equal(got, binning.tile_list(lists, b, t, tiles))
            its = pin.items[ioff[g]:ioff[g + 1]].long()
            assert (its[:, 0] == g).all()
            bounds = torch.arange(int(off[g]), int(off[g + 1]) + group, group).clamp_max(off[g + 1])
            assert torch.equal(its[:, 1], bounds[:its.shape[0]])
            assert torch.equal(its[:, 2], bounds[1:its.shape[0] + 1])
    face_of = torch.repeat_interleave(torch.arange(2 * 60), (pin.face_off[1:] - pin.face_off[:-1]).long())
    fe = pin.face_entries.long()
    assert torch.equal(fe.sort().values, torch.arange(pin.entries.numel()))
    tile_of = torch.repeat_interleave(torch.arange(2 * NT), (off[1:] - off[:-1]))
    assert torch.equal(face_of, tile_of[fe] // NT * 60 + pin.entries[fe].long())
    for f in range(120):
        seg = fe[pin.face_off[f]:pin.face_off[f + 1]]
        assert (seg[1:] > seg[:-1]).all()


@pytest.mark.parametrize('kw', [dict(), dict(aggr_func_rgb='hard', aggr_func_alpha='hard'),
                                dict(aggr_func_alpha='sum', texture_type='vertex')],
                         ids=['softmax-prod', 'hard', 'sum-vertex'])
def test_splitting_changes_nothing(kw, rng):
    """Items of 1 face, of 8, or one per tile: the same counts and images
    within 1e-5, and the same threshold."""
    vertex = kw.get('texture_type') == 'vertex'
    fv, tex = soup(rng, F=40, T=3 if vertex else 4, radius=(0.2, 0.5))
    if vertex:
        tex = tex.reshape(1, 40, 3, 3)
    p = make_params(image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=4, **kw)
    outs = [port_forward(fv, tex, p, True, group=g) for g in (1, 8, 40)]
    assert (outs[0][2] > 4).any()
    for img, ag, cnt, thr in outs[1:]:
        assert torch.equal(cnt, outs[0][2])
        assert torch.equal(thr, outs[0][3])
        torch.testing.assert_close(img, outs[0][0], rtol=0, atol=1e-5)
        torch.testing.assert_close(ag, outs[0][1], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# against the JAX package's pxg layout (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard'),
    dict(dist_func='barycentric', aggr_func_alpha='sum'),
    dict(texture_type='vertex', aggr_func_alpha='hard'),
], ids=['softmax-prod', 'hard', 'bary-sum', 'vertex'])
def test_forward_against_jax_pxg(kw, rng, pxg_on):
    """``soft_rasterize_fwd_pxg`` with the threshold against the port's
    plain pxg forward with items of 8 faces (the tiles split), on the JAX
    suite's random mesh: counts exactly, the threshold where it binds,
    images and aggregates at the suite's tolerances, rgb pixels beyond them
    explained as knife edges (``test_torch_softras.assert_rgb_close``)."""
    vertex = kw.get('texture_type') == 'vertex'
    F, K = 40, 2
    fv = make_random_mesh(rng, num_faces=F).reshape(1, F, 9)
    tex = rng.uniform(size=(1, F, 3 if vertex else 4, 3)).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=K,
              **kw)
    p = make_params(**kw)
    oj, aj, auxj = (np.asarray(a) for a in jax_pxg.soft_rasterize_fwd_pxg(
        jnp.asarray(fv), jnp.asarray(tex), jax_params(**kw), True))
    img, ag, cnt, thr = port_forward(fv, tex, p, True)
    np.testing.assert_array_equal(cnt.numpy(), auxj[:, 0])
    assert (cnt > K).any()
    # XLA contracts FMAs where PyTorch rounds each operation, so a depth can
    # move by a few ulps and two candidates of a pixel swap places
    binding = cnt.numpy() > K
    t_got, t_want = thr.numpy()[binding], auxj[:, 1][binding]
    assert (np.abs(t_got - t_want) > 1e-6 * np.abs(t_want)).mean() <= 0.01
    ties = texel_tie_variants(lambda: port_forward(fv, tex, p)[0])
    exact = port_forward(fv, tex, p, dtype=torch.float64)[0]
    assert_rgb_close(img.numpy()[:, :3], oj[:, :3], ties[:, :, :3], exact.numpy()[:, :3])
    assert_close_except_edges(img.numpy()[:, 3], oj[:, 3], 5e-4, 1e-4)
    if kw.get('aggr_func_rgb') == 'hard':
        np.testing.assert_allclose(ag.numpy()[:, 0], aj[:, 0], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(ag.numpy()[:, 1], aj[:, 1])
    else:
        assert_close_except_edges(ag.numpy(), aj, 5e-4, 1e-4, pixel_axis=1)


@pytest.mark.parametrize('case', ['softmax-K4', 'hard-K2', 'vertex-K4'])
def test_backward_against_jax_pxg(case, rng, pxg_on):
    """``soft_rasterize_bwd_pxg`` on its own forward against the port's
    gradient through ``soft_rasterize(device='cpu')`` on the pxg route, the
    truncation binding."""
    F = 40
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    T = 4
    if case == 'hard-K2':
        kw.update(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard',
                  max_faces_per_pixel_for_grad=2)
    elif case == 'vertex-K4':
        kw.update(texture_type='vertex')
        T = 3
    fv, tex = soup(rng, F=F, T=T, radius=(0.2, 0.45))
    tex = tex.reshape(1, F, 3, 3) if case == 'vertex-K4' else tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, auxj = jax_pxg.soft_rasterize_fwd_pxg(fj, tj, pj, True)
    assert float(auxj[:, 0].max()) > kw['max_faces_per_pixel_for_grad']
    gfj, gtj = jax_pxg.soft_rasterize_bwd_pxg(fj, tj, oj, aj, auxj, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    assert_grad_close(x.grad.numpy(), np.asarray(gfj))
    if case == 'vertex-K4':
        assert_grad_close(t.grad.numpy(), np.asarray(gtj))
    else:
        assert_grad_close(fold_ties(t.grad.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# against the oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize('dist_func', ['hard', 'barycentric', 'euclidean'])
@pytest.mark.parametrize('rgb_func', ['hard', 'softmax'])
@pytest.mark.parametrize('alpha_func', ['hard', 'sum', 'prod'])
def test_forward_configs(dist_func, rgb_func, alpha_func, rng, pxg_on):
    fv, tex = soup(rng, F=24, T=4)
    out, _ = run_both_pxg(fv, tex, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                          dist_func=dist_func, aggr_func_rgb=rgb_func,
                          aggr_func_alpha=alpha_func)
    check_images(*out, softmax=rgb_func == 'softmax')


@pytest.mark.parametrize('kind', ['vertex', 'batched', 'size24'])
def test_forward_kinds(kind, rng, pxg_on):
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    if kind == 'vertex':
        fv, tex = soup(rng, F=24, T=3)
        tex = tex.reshape(1, 24, 3, 3)
        kw.update(texture_type='vertex', background_color=(0.2, 0.4, 0.6))
    elif kind == 'batched':
        fv, tex = soup(rng, F=150, B=2, T=4, radius=(0.05, 0.2))
    else:
        # 24 px: divisible by 8, not by 16; a ragged last tile
        fv, tex = soup(rng, F=24, T=4)
        kw['image_size'] = 24
    out, _ = run_both_pxg(fv, tex, **kw)
    check_images(*out)


def test_candidate_count_matches_oracle(rng, pxg_on):
    F = 24
    fv, tex = soup(rng, F=F, T=4)
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=F)
    _, _, fid = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    _, _, cnt = soft_rasterize_with_aux(fv, tex, make_params(**kw), device='cpu')
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray((fid[0] >= 0).sum(0)))


@pytest.mark.parametrize('K', [1, 4, 40])
def test_threshold_equals_the_binned_one(K, rng, pxg_on):
    """The threshold merged from the items' depth lists equals the binned
    route's map to the bit (``far`` where a pixel has at most K
    candidates)."""
    F = 64
    fv, tex = soup(rng, F=F, T=1, centre=(-0.2, 0.2), radius=(0.5, 0.8))
    p = make_params(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=K)
    _, _, cnt, thr = port_forward(fv, tex, p, True, group=8)
    assert (cnt > K).any()
    torch.testing.assert_close(thr, torch_impl.topk_threshold_plain(torch.tensor(fv), p),
                               rtol=0, atol=0)
    assert (thr[cnt <= K] == p.far).all()


@pytest.mark.parametrize('dist_func', ['euclidean', 'barycentric'])
def test_backward_T1(dist_func, rng, pxg_on):
    F = 24
    fv, tex = soup(rng, F=F, T=1)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    check_grads(*grads_both_pxg(fv, tex, g, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                                dist_func=dist_func, max_faces_per_pixel_for_grad=F))


@pytest.mark.parametrize('kind', ['vertex', 'hard', 'batched', 'sum-alpha', 'size24'])
def test_backward_kinds(kind, rng, pxg_on):
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    B, F, T = 1, 16, 4
    if kind == 'vertex':
        kw.update(texture_type='vertex')
        T = 3
    elif kind == 'hard':
        kw.update(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')
    elif kind == 'batched':
        B, F = 2, 150
    elif kind == 'sum-alpha':
        kw.update(aggr_func_alpha='sum', dist_func='barycentric')
    else:
        kw['image_size'] = 24
    fv, tex = soup(rng, F=F, B=B, T=T, radius=(0.05, 0.2) if F > 100 else (0.15, 0.35))
    if kind == 'vertex':
        tex = tex.reshape(B, F, 3, 3)
    else:
        tex = tie_symmetric(tex)
    is_ = kw['image_size']
    g = rng.randn(B, 4, is_, is_).astype(np.float32)
    kw['max_faces_per_pixel_for_grad'] = F
    check_grads(*grads_both_pxg(fv, tex, g, **kw), surface=kind != 'vertex')


def test_backward_rows_sum_to_the_dense_gradient(rng, pxg_on, monkeypatch):
    """The entry rows summed per face (big faces split over their tiles
    included, emit cap 2) equal the dense plain backward with the same
    threshold."""
    monkeypatch.setattr(binning, 'mt_for', lambda F: 2)
    fv, tex = soup(rng, F=40, B=2, T=4, radius=(0.2, 0.5))
    fvt, text = torch.tensor(fv), torch.tensor(tie_symmetric(tex))
    p = make_params(image_size=48, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    pin = pxg_impl.prep_pxg(fvt, text, p, for_grad=True, group=8)
    img, ag, cnt, thr = pxg_impl.forward(pin, p, True)
    g = torch.tensor(rng.randn(2, 4, 48, 48).astype(np.float32))
    gf, gt = pxg_impl.backward(pin, img, ag, thr, g, p)
    wf, wt = torch_impl.soft_rasterize_bwd_plain(fvt, text, img, ag, thr, g, p)
    assert_grad_close(gf.numpy(), wf.numpy())
    assert_grad_close(fold_ties(gt.numpy()), fold_ties(wt.numpy()))


def test_topk_truncation(pxg_on):
    """K = 4 over 40 overlapping faces: the truncated gradient matches the
    oracle's and differs from 'full'."""
    rng = np.random.RandomState(0)
    F = 40
    fv, tex = soup(rng, F=F, T=4, radius=(0.3, 0.6))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    topk = grads_both_pxg(fv, tex, g, **kw)
    check_grads(*topk)
    x = torch.tensor(fv, requires_grad=True)
    (soft_rasterize(x, tex, device='cpu', grad_mode='full', **kw) * torch.tensor(g)).sum().backward()
    assert np.abs(topk[2] - x.grad.numpy()).max() > 1e-3 * np.abs(x.grad.numpy()).max()


# --------------------------------------------------------------------------
# the slice: Renderer.render_mesh on the pxg route
# --------------------------------------------------------------------------

@pytest.mark.parametrize('mode', [None, 'rgb'])
def test_render_mesh_on_the_pxg_route_matches_jax(mode, pxg_on):
    """``Renderer(image_size=64, device='cpu').render_mesh`` under
    JR_LAYOUT=pxg against ``jrender_tpu.Renderer(backend='jax')`` on the same
    sphere: the image, and the gradients to vertices and textures."""
    import jax
    import jrender_tpu as jr
    import jrender_tpu_torch as jt
    from test_torch_renderer import both_renderers, check_render_rgb, small_sphere
    v, f, tex = small_sphere(11, 2)
    rj, rt = both_renderers(40, image_size=64)
    calls = []
    fwd = pxg_impl.forward
    pxg_impl_forward = lambda *a, **k: calls.append('pxg') or fwd(*a, **k)   # noqa: E731
    rng = np.random.RandomState(12)
    ga = rng.randn(1, 64, 64).astype(np.float32)
    gc = rng.randn(1, 3, 64, 64).astype(np.float32)

    def weigh(out, xp, ga, gc):
        if mode == 'rgb':
            return xp.sum(out * gc)
        return xp.sum(out[0] * ga) + xp.sum(out[1] * gc)

    def loss_j(vv, tt):
        return weigh(rj.render_mesh(jr.Mesh(vv, f, textures=tt, texture_res=2), mode=mode), jnp,
                     ga, gc)

    gvj, gtj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(tex))
    outj = rj.render_mesh(jr.Mesh(v, f, textures=tex, texture_res=2), mode=mode)
    vt = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(tex, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pxg_impl, 'forward', pxg_impl_forward)
        out = rt.render_mesh(jt.Mesh(vt, f, textures=tt, texture_res=2, device='cpu'), mode=mode)
    assert calls == ['pxg']
    weigh(out, torch, torch.tensor(ga), torch.tensor(gc)).backward()
    ct, cj = (out, outj) if mode == 'rgb' else (out[1], outj[1])

    def new_mesh():
        return jt.Mesh(v, f, textures=tex, texture_res=2, device='cpu')

    check_render_rgb(rt, new_mesh, ct.detach().numpy(), np.asarray(cj))
    if mode is None:
        assert_close_except_edges(out[0].detach().numpy(), np.asarray(outj[0]), ATOL, RTOL)
    assert_grad_close(vt.grad.numpy(), np.asarray(gvj))
    assert_grad_close(fold_ties(tt.grad.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# wrappers and entry points
# --------------------------------------------------------------------------

def test_route_needs_the_layout(rng, monkeypatch):
    """With JR_LAYOUT unset no call takes the pxg route, whatever
    JR_DIR_MAX says; under pxg the forward and backward take it and nothing
    of the binned or dir routes, and a size not divisible by 8 is binned."""
    monkeypatch.delenv('JR_LAYOUT', raising=False)
    monkeypatch.delenv('JR_DIR_MAX', raising=False)
    fv, tex = soup(rng, F=24, T=1)
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or fn(*a, **k))

    for mod, name in ((pxg_impl, 'forward'), (pxg_impl, 'backward'),
                      (dir_impl, 'forward'), (dir_impl, 'backward'),
                      (cuda_impl, 'soft_rasterize_fwd'), (cuda_impl, 'soft_rasterize_bwd')):
        spy(mod, name)
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=4, device='cpu')
    x = torch.tensor(fv, requires_grad=True)
    soft_rasterize(x, tex, **kw).sum().backward()
    assert calls == ['soft_rasterize_fwd', 'soft_rasterize_bwd']
    monkeypatch.setenv('JR_LAYOUT', 'pxg')
    monkeypatch.setenv('JR_DIR_MAX', '4096')
    for size, want in ((32, ['forward', 'backward']),
                       (20, ['soft_rasterize_fwd', 'soft_rasterize_bwd'])):
        calls.clear()
        x.grad = None
        soft_rasterize(x, tex, **{**kw, 'image_size': size}).sum().backward()
        assert calls == want and x.grad.abs().max() > 0
    calls.clear()
    soft_rasterize_with_aux(fv, tex, make_params(image_size=32), device='cpu')
    assert calls == ['forward']


def test_pxg_wrappers_refuse_cpu_tensors(rng):
    fv, tex = soup(rng, F=8)
    p = make_params(image_size=32)
    pin = pxg_impl.prep_pxg(torch.tensor(fv), torch.tensor(tex), p, for_grad=True)
    parts, _ = pxg_impl.fwd_partials_plain(pin, p, False)
    img, ag, cnt = pxg_impl.combine_plain(pin, parts, p)
    wrappers = (pxg_impl.launch_pxg_fwd, pxg_impl.launch_pxg_combine, pxg_impl.launch_pxg_thr,
                pxg_impl.launch_pxg_bwd, segment_sum.launch_segment_sum)
    faces = segment_sum.SegmentOrder(None, pin.face_off, pin.face_entries, 8)
    before = [w.launches for w in wrappers]
    for call in (lambda: pxg_impl.launch_pxg_fwd(pin, p, True),
                 lambda: pxg_impl.launch_pxg_combine(pin, parts, p),
                 lambda: pxg_impl.launch_pxg_thr(pin, None, cnt, p),
                 lambda: pxg_impl.launch_pxg_bwd(pin, img, ag, None, torch.ones_like(img), p),
                 lambda: segment_sum.launch_segment_sum(torch.zeros(pin.entries.numel(), 21),
                                                        faces)):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    assert before == [w.launches for w in wrappers]
    with pytest.raises(ValueError, match='for_grad'):
        tiled.sum_plain(pin._replace(face_off=None), torch.zeros(1, 21), p)
    with pytest.raises(ValueError):
        pxg_impl.prep_pxg(torch.tensor(fv), torch.tensor(tex), p, group=0)
