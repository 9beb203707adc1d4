"""The port's f_px route (wide tiles, untruncated backward) against the JAX package, on the CPU.

The route is taken where ``JR_LAYOUT=f_px``, 16 x min(128, is) tiles divide
the image and the top-K truncation does not bind; every test sets the
variable with ``monkeypatch``, which restores it, and the JAX side's
layout with ``monkeypatch.setattr(pallas_impl, 'LAYOUT', ...)``, so the
JAX suite's own routing never sees it.  On the CPU the f_px wrappers take
their plain versions, which read what the kernels read: the binning at the
route's tile shape, written out tile after tile and cut into work items of
32 faces (``fpx_impl.prep_fpx``).  This file also holds the routing of all
four layouts against ``_pallas_route``.

The JAX side is its f_px layout itself (``pallas_impl.soft_rasterize_fwd_pallas``
/ ``_bwd_pallas`` in interpret mode, as tests/test_softras_pallas.py runs
it) in three cases at 32 and 48 px, and the oracle (``jax_impl``, with K =
F: the untruncated gradient) elsewhere.  Tolerances: images those of the
JAX suite (rgb atol 2e-5 with knife-edge pixels explained,
``test_torch_softras.assert_rgb_close``; alpha atol 5e-4 + rtol 1e-4
against the f_px layout, whose kernel multiplies 1 - sf as a tree,
pallas_impl.py:368-374, where the port multiplies in list order; atol
2e-5 + rtol 1e-4 against the oracle), on all but 1% of the pixels; counts
exact; gradients atol 2e-3 * max|grad|, rtol 2e-3 with tie-symmetric
textures (``utils/checks.py``), on every entry; ``render_mesh``'s
gradients against the port's binned route on every entry and against the
JAX package no further than the binned route is.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import api as jax_api
from jrender_tpu.ops.softras import jax_impl, pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import (cuda_impl, fpx_impl, make_params, pxf_impl, route,
                                          soft_rasterize, torch_impl)
from jrender_tpu_torch.ops.softras.api import soft_rasterize_with_aux
from jrender_tpu_torch.utils.checks import fold_ties, tie_symmetric

from conftest import make_random_mesh
from test_torch_softras import (ATOL, RTOL, assert_close_except_edges, assert_grad_close,
                                assert_rgb_close, check_grads, check_images, soup,
                                texel_tie_variants)

torch.set_num_threads(2)

SIZES = (20, 24, 32, 48, 64, 96, 128, 144, 160, 256)


@pytest.fixture
def fpx_on(monkeypatch):
    """The f_px layout in both packages."""
    monkeypatch.setenv('JR_LAYOUT', 'f_px')
    monkeypatch.setattr(pallas_impl, 'LAYOUT', 'f_px')


def port_forward(fv, tex, p, dtype=torch.float32):
    """The port's plain f_px forward: (images, aggrs, counts)."""
    pin = fpx_impl.prep_fpx(torch.tensor(fv, dtype=dtype), torch.tensor(tex, dtype=dtype), p)
    return fpx_impl.forward(pin, p)[:3]


# --------------------------------------------------------------------------
# the route, over all four layouts
# --------------------------------------------------------------------------

def mapped(want: str, size: int) -> str:
    """The port's route for a JAX route: 'pxt' and the oracle ('jax') are
    served binned, and so is 'f_px' where its tiles do not divide the size
    (the JAX forward asserts there)."""
    if want == 'f_px':
        return 'f_px' if fpx_impl.runs(size) else 'binned'
    return {'dir': 'dir', 'pxg': 'pxg', 'px_f': 'px_f', 'pxt': 'binned', 'jax': 'binned'}[want]


@pytest.mark.parametrize('layout', ['pxt', 'pxg', 'px_f', 'f_px'])
@pytest.mark.parametrize('need_grad', [True, False])
@pytest.mark.parametrize('dir_max', [None, '4096'])
def test_route_matches_jax(layout, need_grad, dir_max, monkeypatch):
    """route.route(p, F, need_grad) equals ``_pallas_route(p, F, for_grad)``
    mapped to the port's routes, over sizes, face counts and the truncation
    binding or not; 'dir' only under 'pxt'."""
    monkeypatch.setattr(pallas_impl, 'LAYOUT', layout)
    monkeypatch.setenv('JR_LAYOUT', layout)
    if dir_max is None:
        monkeypatch.delenv('JR_DIR_MAX', raising=False)
    else:
        monkeypatch.setenv('JR_DIR_MAX', dir_max)
    seen = set()
    for F in (8, 300):
        for size in SIZES:
            for kw in (dict(), dict(grad_mode='full'), dict(max_faces_per_pixel_for_grad=400)):
                want = jax_api._pallas_route(jax_params(image_size=size, **kw), F, need_grad)
                got = route.route(make_params(image_size=size, **kw), F, need_grad)
                assert got == mapped(want, size), (layout, F, size, kw, need_grad, want)
                seen.add(got)
    if layout in ('px_f', 'f_px'):
        assert 'dir' not in seen and layout in seen


def test_route_table(monkeypatch):
    """The f_px domain: 16 x min(128, is) tiles divide the size (144 and 160
    px do not: 16 x 128 tiles); a binding truncation with a gradient goes to
    the binned route."""
    assert [s for s in SIZES if fpx_impl.runs(s)] == [32, 48, 64, 96, 128, 256]
    assert [pxf_impl.tile_for(s) for s in SIZES] == [0, 8, 32, 16, 32, 32, 32, 16, 32, 32]
    monkeypatch.setenv('JR_LAYOUT', 'f_px')
    p = make_params(image_size=64)
    assert route.route(p, 300, True) == 'binned'
    assert route.route(p, 300, False) == 'f_px'
    assert route.route(p, 8, True) == 'f_px'
    assert route.route(make_params(image_size=64, grad_mode='full'), 300, True) == 'f_px'
    assert route.route(make_params(image_size=144), 8, False) == 'binned'


# --------------------------------------------------------------------------
# the work lists
# --------------------------------------------------------------------------

def test_tiles_lists_and_items(rng):
    """Tiles of 16 x 48 at 48 px; each tile's entries are the binning's
    list at that shape; items of at most 32 faces cut them in order."""
    from jrender_tpu_torch.ops.softras import binning
    fv, tex = soup(rng, F=60, B=2)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    p = make_params(image_size=48)
    pin = fpx_impl.prep_fpx(fvt, text, p, for_grad=True)
    assert (pin.tile_h, pin.tile_w, pin.tiles_y, pin.tiles_x) == (16, 48, 3, 1)
    lists = cuda_impl.prepare(fvt, text, p, tile_h=16, tile_w=48).lists
    off, ioff = pin.tile_off.long(), pin.item_off.long()
    for b in range(2):
        for t in range(3):
            g = b * 3 + t
            assert torch.equal(pin.entries[off[g]:off[g + 1]], binning.tile_list(lists, b, t, 1))
            its = pin.items[ioff[g]:ioff[g + 1]].long()
            assert (its[:, 2] - its[:, 1]).max() <= fpx_impl.GROUP
            assert int(its[0, 1]) == int(off[g]) and int(its[-1, 2]) == int(off[g + 1])
    with pytest.raises(ValueError):
        fpx_impl.prep_fpx(fvt, text, make_params(image_size=144))


# --------------------------------------------------------------------------
# against the JAX package's f_px layout (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize('size,kw', [
    (32, dict()),
    (48, dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')),
], ids=['32-softmax-prod', '48-hard'])
def test_forward_against_jax_fpx(size, kw, rng, fpx_on):
    """``soft_rasterize_fwd_pallas`` against the port's plain f_px forward
    on the JAX suite's random mesh: images and aggregates at the suite's
    tolerances (alpha at the f_px layout's tree-product one), hard winners
    exactly; the counts against the oracle's candidates."""
    F = 40
    fv = make_random_mesh(rng, num_faces=F).reshape(1, F, 9)
    tex = rng.uniform(size=(1, F, 4, 3)).astype(np.float32)
    kw = dict(image_size=size, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=F,
              **kw)
    p = make_params(**kw)
    oj, aj, _ = (np.asarray(a) for a in pallas_impl.soft_rasterize_fwd_pallas(
        jnp.asarray(fv), jnp.asarray(tex), jax_params(**kw)))
    img, ag, cnt = port_forward(fv, tex, p)
    ties = texel_tie_variants(lambda: port_forward(fv, tex, p)[0])
    exact = port_forward(fv, tex, p, dtype=torch.float64)[0]
    assert_rgb_close(img.numpy()[:, :3], oj[:, :3], ties[:, :, :3], exact.numpy()[:, :3])
    assert_close_except_edges(img.numpy()[:, 3], oj[:, 3], 5e-4, 1e-4)
    if kw.get('aggr_func_rgb') == 'hard':
        np.testing.assert_allclose(ag.numpy()[:, 0], aj[:, 0], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(ag.numpy()[:, 1], aj[:, 1])
    else:
        assert_close_except_edges(ag.numpy(), aj, 5e-4, 1e-4, pixel_axis=1)
    _, _, fid = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray((fid[0] >= 0).sum(0)))


def test_backward_against_jax_fpx(rng, fpx_on):
    """``soft_rasterize_bwd_pallas`` (untruncated) on its own forward
    against the port's gradient through ``soft_rasterize(device='cpu')`` on
    the f_px route with ``grad_mode='full'``, the JAX kernel's semantics."""
    F = 40
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    fv, tex = soup(rng, F=F, T=4, radius=(0.2, 0.45))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = pallas_impl.soft_rasterize_fwd_pallas(fj, tj, pj)
    gfj, gtj = pallas_impl.soft_rasterize_bwd_pallas(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    assert route.route(make_params(grad_mode='full', **kw), F, True) == 'f_px'
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', grad_mode='full', **kw) * torch.tensor(g)).sum().backward()
    assert_grad_close(x.grad.numpy(), np.asarray(gfj))
    assert_grad_close(fold_ties(t.grad.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# against the oracle
# --------------------------------------------------------------------------

def run_both_fpx(fv, tex, **kw):
    """The JAX oracle and the port's f_px route (``soft_rasterize_with_aux``,
    device='cpu') on the same inputs, as ``check_images`` takes them."""
    pj, pt = jax_params(**kw), make_params(**kw)
    assert route.route(pt, fv.shape[1], False) == 'f_px'
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex), pj)
    ot, at, _ = soft_rasterize_with_aux(fv, tex, pt, device='cpu')
    ties = texel_tie_variants(lambda: port_forward(fv, tex, pt)[0])
    exact = port_forward(fv, tex, pt, dtype=torch.float64)[0]
    return np.asarray(oj), np.asarray(aj), ot.numpy(), at.numpy(), ties, exact.numpy()


def grads_both_fpx(fv, tex, g, **kw):
    """The oracle's untruncated gradient (K = F) and the port's through
    ``soft_rasterize(grad_mode='full', device='cpu')`` on the f_px route."""
    F = fv.shape[1]
    pt = make_params(grad_mode='full', **kw)
    assert route.route(pt, F, True) == 'f_px'
    pj = jax_params(max_faces_per_pixel_for_grad=F, **kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', grad_mode='full', **kw) * torch.tensor(g)).sum().backward()
    return np.asarray(gfj), np.asarray(gtj), x.grad.numpy(), t.grad.numpy()


@pytest.mark.parametrize('dist_func', ['hard', 'barycentric', 'euclidean'])
@pytest.mark.parametrize('rgb_func', ['hard', 'softmax'])
@pytest.mark.parametrize('alpha_func', ['hard', 'sum', 'prod'])
def test_forward_configs(dist_func, rgb_func, alpha_func, rng, fpx_on):
    fv, tex = soup(rng, F=24, T=4)
    out = run_both_fpx(fv, tex, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                       dist_func=dist_func, aggr_func_rgb=rgb_func, aggr_func_alpha=alpha_func)
    check_images(*out, softmax=rgb_func == 'softmax')


@pytest.mark.parametrize('kind', ['vertex', 'batched', 'size48'])
def test_forward_kinds(kind, rng, fpx_on):
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    if kind == 'vertex':
        fv, tex = soup(rng, F=24, T=3)
        tex = tex.reshape(1, 24, 3, 3)
        kw.update(texture_type='vertex', background_color=(0.2, 0.4, 0.6))
    elif kind == 'batched':
        fv, tex = soup(rng, F=150, B=2, T=4, radius=(0.05, 0.2))
    else:
        # 48 px: tiles of 16 x 48, three rows of them
        fv, tex = soup(rng, F=24, T=4)
        kw['image_size'] = 48
    check_images(*run_both_fpx(fv, tex, **kw))


def test_candidate_count_and_ties(rng, fpx_on):
    """Counts equal the oracle's; on ``checks.tie_soup`` (exact depth ties)
    the hard winner is the lowest id, as on the binned route."""
    from jrender_tpu_torch.utils.checks import tie_soup
    F = 24
    fv, tex = soup(rng, F=F, T=4)
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=F)
    _, _, fid = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    _, _, cnt = soft_rasterize_with_aux(fv, tex, make_params(**kw), device='cpu')
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray((fid[0] >= 0).sum(0)))
    tie = tie_soup()
    tex_t = rng.uniform(size=(1, 4, 1, 3)).astype(np.float32)
    p = make_params(image_size=32, dist_func='hard', aggr_func_rgb='hard',
                    aggr_func_alpha='hard')
    img, ag, _ = soft_rasterize_with_aux(tie, tex_t, p, device='cpu')
    want = torch_impl.soft_rasterize_fwd_plain(torch.tensor(tie), torch.tensor(tex_t), p)
    assert torch.equal(ag, want[1]) and torch.equal(img, want[0])


@pytest.mark.parametrize('dist_func', ['euclidean', 'barycentric'])
def test_backward_T1(dist_func, rng, fpx_on):
    F = 24
    fv, tex = soup(rng, F=F, T=1)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    check_grads(*grads_both_fpx(fv, tex, g, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                                dist_func=dist_func))


@pytest.mark.parametrize('kind', ['vertex', 'hard', 'batched', 'sum-alpha', 'size48'])
def test_backward_kinds(kind, rng, fpx_on):
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
        kw['image_size'] = 48
    fv, tex = soup(rng, F=F, B=B, T=T, radius=(0.05, 0.2) if F > 100 else (0.15, 0.35))
    tex = tex.reshape(B, F, 3, 3) if kind == 'vertex' else tie_symmetric(tex)
    is_ = kw['image_size']
    g = rng.randn(B, 4, is_, is_).astype(np.float32)
    check_grads(*grads_both_fpx(fv, tex, g, **kw), surface=kind != 'vertex')


def test_binding_truncation_takes_the_binned_route(rng, fpx_on, monkeypatch):
    """K = 4 < F with a gradient: the f_px layout gives the oracle's
    truncated gradient through the binned route, and calls no f_px code."""
    calls = []
    for name in ('forward', 'backward'):
        fn = getattr(fpx_impl, name)
        monkeypatch.setattr(fpx_impl, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    fv, tex = soup(rng, F=40, T=4, radius=(0.3, 0.6))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    pj = jax_params(**kw)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    assert calls == []
    check_grads(np.asarray(gfj), np.asarray(gtj), x.grad.numpy(), t.grad.numpy())
    with torch.no_grad():
        soft_rasterize(x, t, device='cpu', **kw)
    assert calls == ['forward']


def test_backward_refuses_a_threshold(rng):
    fv, tex = soup(rng, F=8, T=1)
    p = make_params(image_size=32)
    pin = fpx_impl.prep_fpx(torch.tensor(fv), torch.tensor(tex), p, for_grad=True)
    img, ag, cnt, thr = fpx_impl.forward(pin, p)
    assert thr is None
    with pytest.raises(ValueError):
        fpx_impl.forward(pin, p, True)
    with pytest.raises(ValueError):
        fpx_impl.backward(pin, img, ag, torch.ones_like(img[:, 0]), torch.ones_like(img), p)
    with pytest.raises(ValueError):
        fpx_impl.launch_fpx_fwd(pin, p)                        # CPU tensors


# --------------------------------------------------------------------------
# the whole path: Renderer.render_mesh on the f_px route
# --------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['rgb', None])
def test_render_mesh_on_the_fpx_route_matches_jax(mode, monkeypatch):
    """``Renderer(image_size=64, max_faces_per_pixel_for_grad=400,
    device='cpu').render_mesh`` under JR_LAYOUT=f_px (K >= F: the forward
    and the untruncated backward on f_px) against ``jrender_tpu.Renderer(
    backend='jax')``: the image; the gradients to vertices and textures
    against the port's binned route on every entry, and against the JAX
    package no further than the binned route is (at this view one vertex
    entry of the rgb gradient lies 2.5e-3 of scale from the JAX one on both
    routes: a knife-edge pixel)."""
    import jax
    import jrender_tpu as jr
    import jrender_tpu_torch as jt
    from jrender_tpu_torch.utils.checks import grad_beyond
    from test_torch_renderer import both_renderers, check_render_rgb, small_sphere
    v, f, tex = small_sphere(11, 2)
    rj, rt = both_renderers(40, image_size=64, max_faces_per_pixel_for_grad=400)
    calls = []
    fwd, bwd = fpx_impl.forward, fpx_impl.backward
    rng = np.random.RandomState(13)
    ga = rng.randn(1, 64, 64).astype(np.float32)
    gc = rng.randn(1, 3, 64, 64).astype(np.float32)

    def weigh(out, xp, ga, gc):
        if mode == 'rgb':
            return xp.sum(out * gc)
        return xp.sum(out[0] * ga) + xp.sum(out[1] * gc)

    def loss_j(vv, tt):
        return weigh(rj.render_mesh(jr.Mesh(vv, f, textures=tt, texture_res=2), mode=mode), jnp,
                     ga, gc)

    def port(layout):
        monkeypatch.setenv('JR_LAYOUT', layout)
        vt = torch.tensor(v, requires_grad=True)
        tt = torch.tensor(tex, requires_grad=True)
        out = rt.render_mesh(jt.Mesh(vt, f, textures=tt, texture_res=2, device='cpu'),
                             mode=mode)
        weigh(out, torch, torch.tensor(ga), torch.tensor(gc)).backward()
        return out, vt.grad.numpy(), fold_ties(tt.grad.numpy())

    gvj, gtj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(tex))
    gvj, gtj = np.asarray(gvj), fold_ties(np.asarray(gtj))
    outj = rj.render_mesh(jr.Mesh(v, f, textures=tex, texture_res=2), mode=mode)
    _, gvb, gtb = port('pxt')
    monkeypatch.setattr(fpx_impl, 'forward', lambda *a, **k: calls.append('fwd') or fwd(*a, **k))
    monkeypatch.setattr(fpx_impl, 'backward', lambda *a, **k: calls.append('bwd') or bwd(*a, **k))
    out, gv, gt = port('f_px')
    assert calls == ['fwd', 'bwd']
    ct, cj = (out, outj) if mode == 'rgb' else (out[1], outj[1])

    def new_mesh():
        return jt.Mesh(v, f, textures=tex, texture_res=2, device='cpu')

    check_render_rgb(rt, new_mesh, ct.detach().numpy(), np.asarray(cj))
    if mode is None:
        assert_close_except_edges(out[0].detach().numpy(), np.asarray(outj[0]), ATOL, RTOL)
    for got, binned, want in ((gv, gvb, gvj), (gt, gtb, gtj)):
        assert_grad_close(got, binned)
        assert grad_beyond(got, want)[0] <= grad_beyond(binned, want)[0]
