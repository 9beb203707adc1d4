"""The port's dir route (binning-free SoftRas for small meshes) against the
JAX package, on the CPU.

The route is taken where ``JR_DIR_MAX`` >= F and the image size is
divisible by 8, in both packages; every test sets the variable with
``monkeypatch``, which restores it, so the JAX suite's own routing never
sees it.  On the CPU the dir wrappers take their plain versions
(``dir_impl.fwd_plain`` / ``bwd_plain``), which read what the kernels read:
the face table in Morton order, its bboxes and the faces' original ids.
So these tests hold against the JAX package everything of the route but
the kernel bodies: the routing, the prep (order, inverse, bboxes, rows),
the original-id tie-breaks and the un-permuted gradients.

The JAX side is the oracle (``jax_impl``, as ``test_torch_softras.py``
holds the binned route) over the configurations of the JAX package's own
dir suite (``TestDirParity`` and ``TestTopKTruncationDir``,
tests/test_softras_pallas.py:641-760), and in three cases its dir layout
itself (``dir_impl.soft_rasterize_fwd_dir`` / ``_bwd_dir`` in interpret
mode).  Tolerances are ``test_torch_softras.py``'s: images at the JAX
suite's atol with knife-edge pixels explained, gradients at
atol = 2e-3 * max|grad| and rtol = 2e-3 with tie-symmetric textures.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import api as jax_api
from jrender_tpu.ops.softras import dir_impl as jax_dir
from jrender_tpu.ops.softras import jax_impl, pallas_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import (cuda_impl, dir_impl, make_params, route,
                                           soft_rasterize, torch_impl)
from jrender_tpu_torch.ops.softras.api import soft_rasterize_with_aux
from jrender_tpu_torch.utils.checks import fold_ties, tie_soup, tie_symmetric

from test_torch_softras import (assert_grad_close, check_grads, check_images, soup,
                                texel_tie_variants)

torch.set_num_threads(2)


@pytest.fixture
def dir_on(monkeypatch):
    """The dir route for meshes of up to 4,096 faces, in both packages."""
    monkeypatch.setenv('JR_DIR_MAX', '4096')


def run_both_dir(fv, tex, **kw):
    """The JAX oracle and the port's dir route (``soft_rasterize_with_aux``,
    device='cpu') on the same inputs, as numpy: what ``check_images`` takes,
    and the port's counts."""
    pj, pt = jax_params(**kw), make_params(**kw)
    assert route.route(pt, fv.shape[1], True) == 'dir'
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex), pj)

    def port(dtype=torch.float32):
        fvt, text = torch.tensor(fv, dtype=dtype), torch.tensor(tex, dtype=dtype)
        return dir_impl.fwd_plain(dir_impl.prep_dir(fvt, text, pt), pt, False)

    ot, at, ct = soft_rasterize_with_aux(fv, tex, pt, device='cpu')
    ties = texel_tie_variants(lambda: port()[0])
    exact = port(torch.float64)[0]
    return (np.asarray(oj), np.asarray(aj), ot.numpy(), at.numpy(), ties, exact.numpy()), ct


def grads_both_dir(fv, tex, g, K_oracle=None, **kw):
    """The oracle's gradient (fwd + bwd of ``jax_impl``) and the port's
    through ``soft_rasterize(device='cpu')`` under autograd on the dir
    route, incoming gradient g."""
    pt = make_params(**kw)
    assert route.route(pt, fv.shape[1], True) == 'dir'
    pj = jax_params(**{**kw, 'grad_mode': 'topk', **(
        {} if K_oracle is None else {'max_faces_per_pixel_for_grad': K_oracle})})
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, ids = jax_impl.soft_rasterize_fwd_jax(fj, tj, pj)
    gfj, gtj = jax_impl.soft_rasterize_bwd_jax(fj, tj, oj, aj, ids, jnp.asarray(g), pj)
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    return np.asarray(gfj), np.asarray(gtj), x.grad.numpy(), t.grad.numpy()


# --------------------------------------------------------------------------
# routing and prep
# --------------------------------------------------------------------------

@pytest.mark.parametrize('dir_max', [None, '0', '128', '300'])
def test_route_matches_jax(dir_max, monkeypatch):
    """The port takes 'dir' exactly where ``_pallas_route`` does (with
    JR_LAYOUT unset: the JAX default layout), over faces and sizes."""
    monkeypatch.setattr(pallas_impl, 'LAYOUT', 'pxt')
    if dir_max is None:
        monkeypatch.delenv('JR_DIR_MAX', raising=False)
    else:
        monkeypatch.setenv('JR_DIR_MAX', dir_max)
    for F in (1, 64, 128, 129, 300, 301):
        for size in (16, 20, 24, 32, 36, 40, 64, 72, 100):
            for kw in (dict(), dict(grad_mode='full'), dict(max_faces_per_pixel_for_grad=400)):
                want = jax_api._pallas_route(jax_params(image_size=size, **kw), F) == 'dir'
                got = route.route(make_params(image_size=size, **kw), F, True)
                assert got == ('dir' if want else 'binned'), (F, size, kw)
    assert dir_impl.dir_tile(24) == 8 and dir_impl.dir_tile(32) == 16 and dir_impl.dir_tile(20) == 0


@pytest.mark.parametrize('F,B', [(150, 2), (300, 1)])
def test_prep_matches_jax(F, B, rng):
    """Order, inverse, bboxes and rows against the JAX package's
    ``prep_dir``, which sorts above 128 faces (both sizes here)."""
    fv, tex = soup(rng, F=F, B=B, T=4, centre=(-0.9, 0.9))
    p = make_params(image_size=32, sigma_val=1e-3)
    jp = jax_dir.prep_dir(jnp.asarray(fv), jnp.asarray(tex), jax_params(image_size=32,
                                                                         sigma_val=1e-3))
    table = dir_impl.prep_dir(torch.tensor(fv), torch.tensor(tex), p)
    tab = np.asarray(jp['tab'])[:, :, :F].transpose(0, 2, 1)        # [B, F, 32 + 3T]
    order = tab[..., 31].astype(np.int64)
    np.testing.assert_array_equal(table.ids.numpy(), order)
    assert not (order == np.arange(F)).all()                         # it does reorder
    np.testing.assert_array_equal(table.inv.numpy(), np.asarray(jp['inv'])[:, :F])
    np.testing.assert_array_equal(np.take_along_axis(order, table.inv.numpy().astype(np.int64),
                                                     1), np.broadcast_to(np.arange(F), (B, F)))
    # the inflation is sqrt(threshold) in float32 on both sides here; it
    # can differ by an ulp at other thresholds (dir_impl.prep_dir)
    np.testing.assert_allclose(table.bbox.numpy(),
                               np.asarray(jp['bbox'])[:, :, :F].transpose(0, 2, 1),
                               rtol=1e-6, atol=1e-7)
    rows = table.rows.numpy()
    np.testing.assert_array_equal(rows[..., :9], tab[..., :9])       # the faces themselves
    np.testing.assert_allclose(rows[..., 9:31], tab[..., 9:31], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rows[..., 31:], tab[..., 32:])     # the texels
    assert table.ids.dtype == table.inv.dtype == torch.int32


# --------------------------------------------------------------------------
# forward and threshold against the oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize('size', [32, 24])
@pytest.mark.parametrize('dist_func', ['euclidean', 'barycentric', 'hard'])
def test_forward_dist(dist_func, size, rng, dir_on):
    fv, tex = soup(rng, F=40, T=4)
    out, _ = run_both_dir(fv, tex, image_size=size, sigma_val=1e-3, gamma_val=1e-3,
                          dist_func=dist_func)
    check_images(*out)


@pytest.mark.parametrize('alpha_func', ['prod', 'sum', 'hard'])
def test_forward_alpha(alpha_func, rng, dir_on):
    fv, tex = soup(rng, F=24, T=4)
    out, _ = run_both_dir(fv, tex, image_size=32, sigma_val=1e-3, gamma_val=1e-3,
                          aggr_func_alpha=alpha_func)
    check_images(*out)


@pytest.mark.parametrize('kind', ['hard', 'vertex', 'batched-multichunk'])
def test_forward_kinds(kind, rng, dir_on):
    if kind == 'hard':
        fv, tex = soup(rng, F=24, T=4)
        kw = dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')
    elif kind == 'vertex':
        fv, tex = soup(rng, F=24, T=3)
        kw = dict(texture_type='vertex')
    else:
        # 150 faces, B = 2; small faces: at this density larger ones give
        # more knife-edge pixels than the 1% on the binned route too
        fv, tex = soup(rng, F=150, B=2, T=4, radius=(0.05, 0.2))
        kw = dict()
    out, _ = run_both_dir(fv, tex, image_size=32, sigma_val=1e-3, gamma_val=1e-3, **kw)
    check_images(*out, softmax=kind != 'hard')


def test_candidate_count_matches_oracle(rng, dir_on):
    """The count of candidates per pixel equals the oracle's number of
    valid face ids when K >= F (none cut)."""
    F = 24
    fv, tex = soup(rng, F=F, T=4)
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=F)
    _, _, fid = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    _, _, cnt = soft_rasterize_with_aux(fv, tex, make_params(**kw), device='cpu')
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray((fid[0] >= 0).sum(0)))


@pytest.mark.parametrize('K', [1, 4, 16, 40])
def test_threshold_in_the_forward(K, rng, dir_on):
    """The dir forward's threshold equals the binned route's threshold
    map, and it is the depth of the oracle's K-th face id where a pixel has
    more than K candidates, far elsewhere: the two packages round a depth
    apart by an ulp, which can order a near-tie the other way at 0.2% of
    the pixels (test_torch_softras.py's own allowance)."""
    F = 64
    fv, tex = soup(rng, F=F, T=1, centre=(-0.2, 0.2), radius=(0.5, 0.8))
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=K)
    p = make_params(**kw)
    fvt = torch.tensor(fv)
    table = dir_impl.prep_dir(fvt, torch.tensor(tex), p)
    _, _, cnt, thr = dir_impl.fwd_plain(table, p, True)
    torch.testing.assert_close(thr, torch_impl.topk_threshold_plain(fvt, p), rtol=0, atol=0)
    assert (thr[cnt <= K] == p.far).all() and (cnt > K).any()
    _, _, ids = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    xp, yp = torch_impl.pixel_grid(32)
    depth = torch_impl._candidate_depths(fvt[0], p, xp, yp)
    kth = np.asarray(ids)[0, K - 1].reshape(-1)                       # the K-th nearest id
    over = cnt[0].reshape(-1) > K
    want = depth.gather(1, torch.tensor(kth).clamp_min(0)[:, None].long())[:, 0]
    assert (thr[0].reshape(-1)[over] != want[over]).float().sum().item() <= 0.002 * 32 * 32


def test_tie_soup_winner_is_the_oracles(dir_on):
    """Exact depth ties across Morton places: the lowest original id wins,
    as in the oracle, though the Morton order walks it last."""
    fv = tie_soup()
    tex = np.random.RandomState(0).uniform(size=(1, 4, 1, 3)).astype(np.float32)
    kw = dict(image_size=32, dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')
    p = make_params(**kw)
    table = dir_impl.prep_dir(torch.tensor(fv), torch.tensor(tex), p)
    assert table.ids[0].tolist() != sorted(table.ids[0].tolist())
    oj, aj, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                jax_params(**kw))
    ot, at, _ = soft_rasterize_with_aux(fv, tex, p, device='cpu')
    np.testing.assert_array_equal(at[:, 1].numpy(), np.asarray(aj)[:, 1])
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert set(np.unique(np.asarray(aj)[:, 1]).tolist()) == {-1, 0, 1, 3}
    # the hard-rgb texture gradient goes to the winner's original row
    g = np.random.RandomState(1).randn(1, 4, 32, 32).astype(np.float32)
    gfj, gtj, gft, gtt = grads_both_dir(fv, tex, g, **kw)
    np.testing.assert_allclose(gtt, gtj, rtol=1e-5, atol=1e-5)
    assert np.abs(gtt[0, 2]).max() == 0 and np.abs(gtt[0, 0]).max() > 0


# --------------------------------------------------------------------------
# gradients against the oracle, through soft_rasterize under autograd
# --------------------------------------------------------------------------

@pytest.mark.parametrize('size', [32, 24])
@pytest.mark.parametrize('dist_func', ['euclidean', 'barycentric'])
def test_backward_T1(dist_func, size, rng, dir_on):
    F = 24
    fv, tex = soup(rng, F=F, T=1)
    g = rng.randn(1, 4, size, size).astype(np.float32)
    check_grads(*grads_both_dir(fv, tex, g, image_size=size, sigma_val=1e-3, gamma_val=1e-3,
                                dist_func=dist_func, max_faces_per_pixel_for_grad=F))


@pytest.mark.parametrize('kind', ['vertex', 'hard', 'batched-multichunk', 'K16'])
def test_backward_kinds(kind, rng, dir_on):
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    B, F, T = 1, 16, 4
    if kind == 'vertex':
        kw.update(texture_type='vertex')
        T = 3
    elif kind == 'hard':
        kw.update(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard')
    elif kind == 'batched-multichunk':
        B, F = 2, 150
    else:
        kw.update(max_faces_per_pixel_for_grad=16)
        F = 40
    fv, tex = soup(rng, F=F, B=B, T=T, radius=(0.05, 0.2) if F > 100 else (0.15, 0.35))
    if kind != 'vertex':
        tex = tie_symmetric(tex)
    g = rng.randn(B, 4, 32, 32).astype(np.float32)
    K = kw.get('max_faces_per_pixel_for_grad', F)
    kw['max_faces_per_pixel_for_grad'] = K
    check_grads(*grads_both_dir(fv, tex, g, **kw), surface=kind != 'vertex')


def test_backward_generic_textures_face_totals(rng, dir_on):
    """Four generic texels: the per-face texture totals, as the JAX suite's
    T4 statistical test compares them."""
    fv, tex = soup(rng, F=24, T=4)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    g[:, :3] = g[:, :1]
    _, gtj, _, gtt = grads_both_dir(fv, tex, g, image_size=32, sigma_val=1e-3,
                                    gamma_val=1e-3, aggr_func_rgb='hard',
                                    max_faces_per_pixel_for_grad=24)
    assert_grad_close(gtt.sum(axis=2), gtj.sum(axis=2))


def test_topk_truncation(dir_on):
    """K = 4 over 40 overlapping faces (TestTopKTruncationDir's setup):
    the truncated gradient matches the oracle's, differs from 'full', and
    'full' matches the oracle at K = F."""
    rng = np.random.RandomState(0)
    F = 40
    fv, tex = soup(rng, F=F, T=4, radius=(0.3, 0.6))
    tex = tie_symmetric(tex)
    g = rng.randn(1, 4, 32, 32).astype(np.float32)
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=4)
    _, _, cnt = soft_rasterize_with_aux(fv, tex, make_params(**kw), device='cpu')
    assert int(cnt.max()) > 4                                        # it binds
    topk = grads_both_dir(fv, tex, g, **kw)
    check_grads(*topk)
    full = grads_both_dir(fv, tex, g, K_oracle=F, grad_mode='full', **kw)
    check_grads(*full)
    assert np.abs(topk[2] - full[2]).max() > 1e-3 * np.abs(full[2]).max()


# --------------------------------------------------------------------------
# against the JAX package's dir layout itself (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['multichunk-B2', 'hard', 'topk-K4'])
def test_against_jax_dir_layout(case, rng, dir_on):
    """``dir_impl.soft_rasterize_fwd_dir`` / ``_bwd_dir`` of the JAX package,
    run as its own suite runs them on the CPU, against the port's dir route:
    images, counts, the threshold map and the gradients."""
    B, F, T = 1, 40, 4
    kw = dict(image_size=32, sigma_val=1e-3, gamma_val=1e-3)
    if case == 'multichunk-B2':
        B, F = 2, 150
        kw['max_faces_per_pixel_for_grad'] = F
    elif case == 'hard':
        F = 140
        kw.update(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard',
                  max_faces_per_pixel_for_grad=F)
    else:
        kw['max_faces_per_pixel_for_grad'] = 4
    fv, tex = soup(rng, F=F, B=B, T=T, radius=(0.05, 0.2) if F > 100 else (0.15, 0.45))
    tex = tie_symmetric(tex)
    g = rng.randn(B, 4, 32, 32).astype(np.float32)
    pj, pt = jax_params(**kw), make_params(**kw)
    with_thr = torch_impl.use_threshold(pt, F)
    fj, tj = jnp.asarray(fv), jnp.asarray(tex)
    oj, aj, auxj = jax_dir.soft_rasterize_fwd_dir(fj, tj, pj, with_thr)
    gfj, gtj = jax_dir.soft_rasterize_bwd_dir(fj, tj, oj, aj, auxj, jnp.asarray(g), pj)
    table = dir_impl.prep_dir(torch.tensor(fv), torch.tensor(tex), pt)
    ot, at, ct, tt = dir_impl.forward(table, pt, with_thr)
    oj, aj, auxj = np.asarray(oj), np.asarray(aj), np.asarray(auxj)
    np.testing.assert_array_equal(ct.numpy(), auxj[:, 0])
    if with_thr:
        # XLA contracts FMAs where PyTorch rounds each operation: the same
        # candidate's depth can differ by an ulp
        assert (ct > 4).any()
        np.testing.assert_allclose(tt.numpy(), auxj[:, 1], rtol=1e-6, atol=0)
    assert (np.abs(ot.numpy() - oj) > 2e-5).any(axis=1).mean() <= 0.01
    if case == 'hard':
        np.testing.assert_array_equal(at[:, 1].numpy(), aj[:, 1])
    x = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    (soft_rasterize(x, t, device='cpu', **kw) * torch.tensor(g)).sum().backward()
    assert_grad_close(x.grad.numpy(), np.asarray(gfj))
    assert_grad_close(fold_ties(t.grad.numpy()), fold_ties(np.asarray(gtj)))


# --------------------------------------------------------------------------
# wrappers and entry points
# --------------------------------------------------------------------------

def test_route_off_by_default(rng, monkeypatch):
    """Without JR_DIR_MAX no call takes the dir route; with it, a call
    takes the dir route for forward and backward and nothing of the
    binned one."""
    monkeypatch.delenv('JR_DIR_MAX', raising=False)
    fv, tex = soup(rng, F=24, T=1)
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or fn(*a, **k))

    for mod, name in ((dir_impl, 'fwd_plain'), (dir_impl, 'bwd_plain'),
                      (cuda_impl, 'soft_rasterize_fwd'), (cuda_impl, 'topk_threshold'),
                      (cuda_impl, 'soft_rasterize_bwd')):
        spy(mod, name)
    kw = dict(image_size=32, sigma_val=1e-3, max_faces_per_pixel_for_grad=4, device='cpu')
    x = torch.tensor(fv, requires_grad=True)
    soft_rasterize(x, tex, **kw).sum().backward()
    assert calls == ['soft_rasterize_fwd', 'topk_threshold', 'soft_rasterize_bwd']
    calls.clear()
    monkeypatch.setenv('JR_DIR_MAX', '24')
    x.grad = None
    soft_rasterize(x, tex, **kw).sum().backward()
    assert calls == ['fwd_plain', 'bwd_plain'] and x.grad.abs().max() > 0
    calls.clear()
    soft_rasterize_with_aux(fv, tex, make_params(image_size=32), device='cpu')
    assert calls == ['fwd_plain']
    monkeypatch.setenv('JR_DIR_MAX', '23')                  # one face too many
    calls.clear()
    soft_rasterize(fv, tex, **kw)
    assert calls == ['soft_rasterize_fwd']


def test_dir_wrappers_refuse_cpu_tensors(rng):
    fv, tex = soup(rng, F=8)
    p = make_params(image_size=32)
    table = dir_impl.prep_dir(torch.tensor(fv), torch.tensor(tex), p)
    img, ag, _, _ = dir_impl.fwd_plain(table, p, False)
    before = (dir_impl.launch_dir_fwd.launches, dir_impl.launch_dir_bwd.launches)
    with pytest.raises(ValueError, match='CUDA'):
        dir_impl.launch_dir_fwd(table, p, True)
    with pytest.raises(ValueError, match='CUDA'):
        dir_impl.launch_dir_bwd(table, img, ag, None, torch.ones_like(img), p)
    assert before == (dir_impl.launch_dir_fwd.launches, dir_impl.launch_dir_bwd.launches)
    for row in (31 + 3, 31 + 9, 31 + 75, 31 + 3 * 64):
        # the forward's dynamic shared memory: rows and ids of a chunk, the
        # list of 256 places, 8 warp counts
        c = cuda_impl.chunk_for(row, dir_impl.FWD_RESERVED_BYTES)
        assert c * 4 * row + 4 * (256 + c + 8) <= cuda_impl.SMEM_BYTES


def test_with_dir_max_sets_and_restores(monkeypatch):
    monkeypatch.setenv('JR_DIR_MAX', '7')
    with dir_impl.with_dir_max(100):
        assert dir_impl.dir_max_faces() == 100
    assert dir_impl.dir_max_faces() == 7
    monkeypatch.delenv('JR_DIR_MAX')
    with pytest.raises(RuntimeError):
        with dir_impl.with_dir_max(0):
            assert dir_impl.dir_max_faces() == 0
            raise RuntimeError
    assert 'JR_DIR_MAX' not in os.environ
