"""The port's px_f route (small square tiles, pixel bands) against the JAX package, on the CPU.

The route is taken where ``JR_LAYOUT=px_f`` and the image size is divisible
by 8; every test sets the variable with ``monkeypatch``, which restores
it, and the JAX side's layout with ``monkeypatch.setattr(pallas_impl,
'LAYOUT', ...)``.  On the CPU the px_f wrappers take their plain versions,
which read what the kernels read: the binning at t x t tiles (t = 32, 16
or 8), written out tile after tile and cut into work items of
``pxf_impl.GROUP`` faces, for the whole image or for one band of tile rows
(``pxf_impl.prep_pxf``).

The JAX side is its px_f layout itself (``pallas_impl.soft_rasterize_fwd_pallas_pf``
/ ``_bwd_pallas_pf`` in interpret mode, as tests/test_softras_pallas.py
runs it) in four cases at 24 to 64 px, one of them a band with ty0 > 0,
and the oracle (``jax_impl``) elsewhere.  Tolerances: against the px_f
layout those of its own suite (tests/test_softras_pallas.py:184-197:
images atol 2e-5 on all but 1% of the pixels, rgb pixels beyond explained
as knife edges; alpha and aggregates atol 5e-4 + rtol 1e-4: its kernel
multiplies 1 - sf as a tree and sums on the MXU), counts exact, the
threshold to 1e-6 relative on all but 1% of the pixels where the
truncation binds (XLA contracts FMAs where PyTorch rounds each operation;
where a pixel has at most K candidates the JAX kernel leaves its largest
candidate depth and the port ``far``, as the binned route does: both pass
every candidate); against the oracle ``test_torch_softras.py``'s;
gradients atol 2e-3 * max|grad|, rtol 2e-3 with tie-symmetric textures,
on every entry.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import jax_impl, pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import (binning, cuda_impl, make_params, pxf_impl, route,
                                          soft_rasterize, tiled, torch_impl)
from jrender_tpu_torch.ops.softras.api import soft_rasterize_with_aux
from jrender_tpu_torch.utils.checks import fold_ties, grad_beyond, tie_symmetric

from conftest import make_random_mesh
from test_torch_softras import (ATOL, RTOL, assert_close_except_edges, assert_grad_close,
                                assert_rgb_close, check_grads, check_images, soup,
                                texel_tie_variants)

torch.set_num_threads(2)


@pytest.fixture
def pxf_on(monkeypatch):
    """The px_f layout in both packages."""
    monkeypatch.setenv('JR_LAYOUT', 'px_f')
    monkeypatch.setattr(pallas_impl, 'LAYOUT', 'px_f')


def port_forward(fv, tex, p, with_thr=False, dtype=torch.float32, **band):
    """The port's plain px_f forward: (images, aggrs, counts, thr or None)."""
    pin = pxf_impl.prep_pxf(torch.tensor(fv, dtype=dtype), torch.tensor(tex, dtype=dtype), p,
                            **band)
    return pxf_impl.forward(pin, p, with_thr)


# --------------------------------------------------------------------------
# tiles, bisection bounds and work lists
# --------------------------------------------------------------------------

def test_tile_and_bisection_bounds():
    """The tile is the JAX layout's default (``_pf_tile_for`` with
    JR_PF_TILE unset); the bisection spans as many keys and takes as many
    steps as ``_thr_bisect_bounds``."""
    for size in (8, 16, 20, 24, 32, 40, 48, 64, 96, 100, 120, 144, 256):
        assert pxf_impl.tile_for(size) == pallas_impl._pf_tile_for(size), size
    for near, far in ((1.0, 100.0), (0.1, 10.0), (0.5, 0.5)):
        lo, hi, steps = pxf_impl.thr_bisect_bounds(near, far)
        jlo, jhi, jsteps = pallas_impl._thr_bisect_bounds(near, far)
        assert (hi - lo, steps) == (jhi - jlo, jsteps)
        assert tiled.depth_key(near) == lo and tiled.depth_key(far) == hi


@pytest.mark.parametrize('band', [None, (1, 2)])
def test_work_lists(band, rng):
    """At 40 px the tiles are 8 x 8 (5 x 5 of them); each tile's entries are
    the binning's list at that tile, cut into items of at most 3 faces
    (``tiled.prep``; the route's items hold up to 128, the same entries); a
    band keeps its rows' tiles only."""
    fv, tex = soup(rng, F=50, B=2, radius=(0.1, 0.4))
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    p = make_params(image_size=40)
    kw = {} if band is None else dict(ty0=band[0], ty_band=band[1])
    pin = tiled.prep(fvt, text, p, 8, 8, 3, True, band)
    assert (pin.tile_h, pin.tiles_y, pin.tiles_x) == (8, 5, 5)
    routed = pxf_impl.prep_pxf(fvt, text, p, for_grad=True, **kw)
    assert (routed.tile_h, routed.tile_w) == (8, 8) and torch.equal(routed.entries, pin.entries)
    lists = cuda_impl.prepare(fvt, text, p, tile_h=8, tile_w=8).lists
    off, ioff = pin.tile_off.long(), pin.item_off.long()
    rows = range(5) if band is None else range(band[0], band[0] + band[1])
    for b in range(2):
        for t in range(25):
            g = b * 25 + t
            got = pin.entries[off[g]:off[g + 1]]
            if t // 5 in rows:
                assert torch.equal(got, binning.tile_list(lists, b, t, 5))
                its = pin.items[ioff[g]:ioff[g + 1]].long()
                assert (its[:, 2] - its[:, 1]).max() <= 3 if its.numel() else got.numel() == 0
            else:
                assert got.numel() == 0 and ioff[g] == ioff[g + 1]
    assert pxf_impl.forward(pin, p, False)[0].shape == (2, 4, 8 * len(rows), 40)
    with pytest.raises(ValueError):
        pxf_impl.prep_pxf(fvt, text, p, ty0=4, ty_band=2)
    with pytest.raises(ValueError):
        pxf_impl.prep_pxf(fvt, text, make_params(image_size=20))


# --------------------------------------------------------------------------
# against the JAX package's px_f layout (interpret mode)
# --------------------------------------------------------------------------

def check_against_jax_pf(out, jax_out, K):
    """The port's (images, aggrs, counts, thr) against the JAX px_f
    forward's (out, aggrs, aux) at its suite's tolerances."""
    img, ag, cnt, thr = out
    oj, aj, auxj = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(cnt.numpy(), auxj[:, 0])
    if thr is not None:
        binding = cnt.numpy() > K
        assert binding.any()
        t_got, t_want = thr.numpy()[binding], auxj[:, 1][binding]
        assert (np.abs(t_got - t_want) > 1e-6 * np.abs(t_want)).mean() <= 0.01
    assert_close_except_edges(img.numpy()[:, :3], oj[:, :3], ATOL, pixel_axis=1)
    assert_close_except_edges(img.numpy()[:, 3], oj[:, 3], 5e-4, 1e-4)
    assert_close_except_edges(ag.numpy(), aj, 5e-4, 1e-4, pixel_axis=1)


@pytest.mark.parametrize('size,kw', [
    (32, dict()),
    (24, dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')),
], ids=['32-softmax-prod-thr', '24-hard'])
def test_forward_against_jax_pxf(size, kw, rng, pxf_on):
    """``soft_rasterize_fwd_pallas_pf`` with the threshold against the
    port's plain px_f forward on the JAX suite's random mesh."""
    F, K = 40, 2
    fv = make_random_mesh(rng, num_faces=F).reshape(1, F, 9)
    tex = rng.uniform(size=(1, F, 4, 3)).astype(np.float32)
    kw = dict(image_size=size, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=K,
              **kw)
    p = make_params(**kw)
    jax_out = pallas_impl.soft_rasterize_fwd_pallas_pf(jnp.asarray(fv), jnp.asarray(tex),
                                                       jax_params(**kw), True)
    out = port_forward(fv, tex, p, True)
    check_against_jax_pf(out, jax_out, K)
    if kw.get('aggr_func_rgb') == 'hard':
        np.testing.assert_array_equal(out[1].numpy()[:, 1], np.asarray(jax_out[1])[:, 1])
    else:
        ties = texel_tie_variants(lambda: port_forward(fv, tex, p)[0])
        exact = port_forward(fv, tex, p, dtype=torch.float64)[0]
        assert_rgb_close(out[0].numpy()[:, :3], np.asarray(jax_out[0])[:, :3],
                         ties[:, :, :3], exact.numpy()[:, :3])


def test_backward_against_jax_pxf(rng, pxf_on):
    """``soft_rasterize_bwd_pallas_pf`` on its own forward against the
    port's gradient through ``soft_rasterize(device='cpu')`` on the px_f
    route, the truncation binding (K = 4)."""
    F = 40
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    fv, tex = soup(rng, F=F, T=4, radius=(0.2, 0.45))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, auxj = pallas_impl.soft_rasterize_fwd_pallas_pf(fj, tj, pj, True)
    assert float(auxj[:, 0].max()) > 4
    gfj, gtj = pallas_impl.soft_rasterize_bwd_pallas_pf(fj, tj, oj, aj, auxj, jnp.asarray(g), pj)
    assert route.route(make_params(**kw), F, True) == 'px_f'
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    assert_grad_close(x.grad.numpy(), np.asarray(gfj))
    assert_grad_close(fold_ties(t.grad.numpy()), fold_ties(np.asarray(gtj)))


def test_band_against_jax_pxf(rng, pxf_on):
    """A band with ty0 > 0 at 64 px (tiles of 32: the second tile row):
    the JAX px_f forward and backward of that band against the port's,
    on band-local maps; pixel centres of the global rows."""
    F, K = 40, 3
    fv, tex = soup(rng, F=F, T=4, radius=(0.2, 0.45))
    tex = tie_symmetric(tex)
    kw = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=K)
    p = make_params(**kw)
    pj = jax_params(**kw)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    ty0 = jnp.asarray(1, jnp.int32)
    jax_out = pallas_impl.soft_rasterize_fwd_pallas_pf(fj, tj, pj, True, ty0, 1)
    pin = pxf_impl.prep_pxf(torch.tensor(fv), torch.tensor(tex), p, ty0=1, ty_band=1,
                            for_grad=True)
    out = pxf_impl.forward(pin, p, True)
    assert out[0].shape == (1, 4, 32, 64)
    check_against_jax_pf(out, jax_out, K)
    # the band's rows of the whole image
    whole = port_forward(fv, tex, p, True)
    for got, full in zip(out, whole):
        assert torch.equal(got, full[..., 32:, :])
    g = rng.randn(1, 4, 32, 64).astype(np.float32)
    gfj, gtj = pallas_impl.soft_rasterize_bwd_pallas_pf(
        fj, tj, *jax_out, jnp.asarray(g), pj, ty0, 1)
    gf, gt = pxf_impl.backward(pin, out[0], out[1], out[3], torch.tensor(g), p)
    assert_grad_close(gf.numpy(), np.asarray(gfj))
    assert_grad_close(fold_ties(gt.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# bands on the port alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize('K', [4, 40])
def test_bands_reassemble_the_image(K, rng):
    """128 px in 4 bands of one tile row (tiles of 32): the bands' images,
    aggregates, counts and thresholds side by side equal the whole image's
    to the bit, and their gradients summed equal the whole gradient."""
    fv, tex = soup(rng, F=120, B=2, T=4, centre=(-0.6, 0.6), radius=(0.2, 0.6))
    fvt, text = torch.tensor(fv), torch.tensor(tie_symmetric(tex))
    p = make_params(image_size=128, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=K)
    whole = pxf_impl.prep_pxf(fvt, text, p, for_grad=True)
    outs = pxf_impl.forward(whole, p, True)
    assert (outs[2] > K).any()
    g = torch.tensor(rng.randn(2, 4, 128, 128).astype(np.float32))
    gf, gt = pxf_impl.backward(whole, outs[0], outs[1], outs[3], g, p)
    parts, sf, st = [], torch.zeros_like(gf), torch.zeros_like(gt)
    for k in range(4):
        pin = pxf_impl.prep_pxf(fvt, text, p, ty0=k, ty_band=1, for_grad=True)
        out = pxf_impl.forward(pin, p, True)
        parts.append(out)
        bf, bt = pxf_impl.backward(pin, out[0], out[1], out[3], g[:, :, 32 * k:32 * (k + 1)], p)
        sf += bf
        st += bt
    for i, full in enumerate(outs):
        assert torch.equal(torch.cat([o[i] for o in parts], dim=-2), full)
    assert_grad_close(sf.numpy(), gf.numpy())
    assert_grad_close(fold_ties(st.numpy()), fold_ties(gt.numpy()))


# --------------------------------------------------------------------------
# against the oracle
# --------------------------------------------------------------------------

def run_both_pxf(fv, tex, **kw):
    pj, pt = jax_params(**kw), make_params(**kw)
    assert route.route(pt, fv.shape[1], False) == 'px_f'
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex), pj)
    ot, at, _ = soft_rasterize_with_aux(fv, tex, pt, device='cpu')
    ties = texel_tie_variants(lambda: port_forward(fv, tex, pt)[0])
    exact = port_forward(fv, tex, pt, dtype=torch.float64)[0]
    return np.asarray(oj), np.asarray(aj), ot.numpy(), at.numpy(), ties, exact.numpy()


def grads_both_pxf(fv, tex, g, **kw):
    """The oracle's gradient and the port's through ``soft_rasterize(
    device='cpu')`` under autograd on the px_f route."""
    pt = make_params(**kw)
    assert route.route(pt, fv.shape[1], True) == 'px_f'
    pj = jax_params(**{**kw, 'grad_mode': 'topk'})
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    return np.asarray(gfj), np.asarray(gtj), x.grad.numpy(), t.grad.numpy()


@pytest.mark.parametrize('dist_func', ['hard', 'barycentric', 'euclidean'])
@pytest.mark.parametrize('rgb_func', ['hard', 'softmax'])
@pytest.mark.parametrize('alpha_func', ['hard', 'sum', 'prod'])
def test_forward_configs(dist_func, rgb_func, alpha_func, rng, pxf_on):
    fv, tex = soup(rng, F=24, T=4)
    out = run_both_pxf(fv, tex, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                       dist_func=dist_func, aggr_func_rgb=rgb_func, aggr_func_alpha=alpha_func)
    check_images(*out, softmax=rgb_func == 'softmax')


@pytest.mark.parametrize('kind', ['vertex', 'batched', 'size24', 'size48'])
def test_forward_kinds(kind, rng, pxf_on):
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    if kind == 'vertex':
        fv, tex = soup(rng, F=24, T=3)
        tex = tex.reshape(1, 24, 3, 3)
        kw.update(texture_type='vertex', background_color=(0.2, 0.4, 0.6))
    elif kind == 'batched':
        fv, tex = soup(rng, F=150, B=2, T=4, radius=(0.05, 0.2))
    else:
        # 24 px: tiles of 8; 48 px: tiles of 16, some uncovered
        fv, tex = soup(rng, F=24, T=4)
        kw['image_size'] = int(kind[4:])
    check_images(*run_both_pxf(fv, tex, **kw))


@pytest.mark.parametrize('K', [1, 4, 40])
def test_threshold_equals_the_binned_one(K, rng, pxf_on):
    """The forward's threshold (a list per pixel for K <= 32, bisection
    above) equals the binned route's map to the bit: ``far`` where a pixel
    has at most K candidates, uncovered tiles included."""
    F = 64
    fv, tex = soup(rng, F=F, T=1, centre=(-0.2, 0.2), radius=(0.5, 0.8))
    p = make_params(image_size=48, sigma_val=1e-3, max_faces_per_pixel_for_grad=K)
    _, _, cnt, thr = port_forward(fv, tex, p, True)
    assert (cnt > K).any()
    torch.testing.assert_close(thr, torch_impl.topk_threshold_plain(torch.tensor(fv), p),
                               rtol=0, atol=0)
    assert (thr[cnt <= K] == p.far).all()


@pytest.mark.parametrize('dist_func', ['euclidean', 'barycentric'])
def test_backward_T1(dist_func, rng, pxf_on):
    F = 24
    fv, tex = soup(rng, F=F, T=1)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    check_grads(*grads_both_pxf(fv, tex, g, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                                dist_func=dist_func, max_faces_per_pixel_for_grad=F))


@pytest.mark.parametrize('kind', ['vertex', 'hard', 'batched', 'sum-alpha', 'size24'])
def test_backward_kinds(kind, rng, pxf_on):
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
    tex = tex.reshape(B, F, 3, 3) if kind == 'vertex' else tie_symmetric(tex)
    is_ = kw['image_size']
    g = rng.randn(B, 4, is_, is_).astype(np.float32)
    kw['max_faces_per_pixel_for_grad'] = F
    check_grads(*grads_both_pxf(fv, tex, g, **kw), surface=kind != 'vertex')


def test_topk_truncation(pxf_on):
    """K = 4 over 40 overlapping faces: the truncated gradient matches the
    oracle's and differs from 'full'."""
    rng = np.random.RandomState(0)
    F = 40
    fv, tex = soup(rng, F=F, T=4, radius=(0.3, 0.6))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    topk = grads_both_pxf(fv, tex, g, **kw)
    check_grads(*topk)
    x = torch.tensor(fv, requires_grad=True)
    (soft_rasterize(x, tex, device='cpu', grad_mode='full', **kw) * torch.tensor(g)).sum().backward()
    assert np.abs(topk[2] - x.grad.numpy()).max() > 1e-3 * np.abs(x.grad.numpy()).max()


def test_wrappers_refuse_cpu_tensors(rng):
    fv, tex = soup(rng, F=8, T=1)
    p = make_params(image_size=32)
    pin = pxf_impl.prep_pxf(torch.tensor(fv), torch.tensor(tex), p, for_grad=True)
    img, ag, cnt, thr = pxf_impl.forward(pin, p, True)
    with pytest.raises(ValueError):
        pxf_impl.launch_pxf_fwd(pin, p, True)
    with pytest.raises(ValueError):
        pxf_impl.launch_pxf_bwd(pin, img, ag, thr, torch.ones_like(img), p)


# --------------------------------------------------------------------------
# the whole path: Renderer.render_mesh on the px_f route
# --------------------------------------------------------------------------

@pytest.mark.parametrize('mode', [None, 'rgb'])
def test_render_mesh_on_the_pxf_route_matches_jax(mode, monkeypatch):
    """``Renderer(image_size=64, device='cpu').render_mesh`` under
    JR_LAYOUT=px_f against ``jrender_tpu.Renderer(backend='jax')`` on the
    same sphere: the image; the gradients to vertices and textures against
    the port's binned route on every entry, and against the JAX package no
    further than the binned route is."""
    import jax
    import jrender_tpu as jr
    import jrender_tpu_torch as jt
    from test_torch_renderer import both_renderers, check_render_rgb, small_sphere
    v, f, tex = small_sphere(11, 2)
    rj, rt = both_renderers(40, image_size=64)
    calls = []
    fwd, bwd = pxf_impl.forward, pxf_impl.backward
    rng = np.random.RandomState(14)
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
    monkeypatch.setattr(pxf_impl, 'forward', lambda *a, **k: calls.append('fwd') or fwd(*a, **k))
    monkeypatch.setattr(pxf_impl, 'backward', lambda *a, **k: calls.append('bwd') or bwd(*a, **k))
    out, gv, gt = port('px_f')
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
