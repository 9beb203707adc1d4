"""The port's volume renderer and NeRF MLP (``jrender_tpu_torch.vol``,
``jrender_tpu_torch.nerf.model``) against the JAX package on the CPU.

The same numpy inputs, made from a seed, and the same draws (JAX's, fed
to the port as tensors) go through both packages.  A gradient's error is
max |JAX - port| over a net's weights as a share of the net's largest
gradient.  Tolerances (their readings in brackets):
  * rays, NDC rays, stratified and importance samples: equal to the bit
    (``linspace0`` repeats XLA's folded ``linspace``; the PDF's normaliser
    and CDF add in XLA's CPU order), so no importance sample changes its
    CDF bin [none did];
  * compositing: 1e-6 of each output's largest value and of the gradient
    [5.3e-7; sigmoid, exp and the maps' sums over samples round
    differently];
  * the encoding: 1e-5 absolute [6e-8, one ulp: sin and cos of inputs up
    to 2^9 reduce their range differently];
  * the MLP in float32: 1e-5 of the largest output and gradient [1.8e-7,
    1.0e-7; matrix products sum in another order];
  * the MLP with bfloat16 operands against JAX's bfloat16: 2e-3 of the
    largest output and 3e-2 of the largest gradient [1.5e-7, 1.5e-8: no
    rounding flipped at this seed; a float32 difference in the last bit
    can flip the bfloat16 rounding of the next layer's input by one
    bfloat16 step, 0.4%], and against float32 at the JAX suite's own bound
    (mean relative 2%, ``tests/test_nerf.py::test_bf16_compute_close_to_f32``);
  * ``render_rays`` and ``render`` (hierarchical, fed draws): 1e-5 of the
    largest value of each output and gradient [1.7e-6].
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jrender_tpu.nerf import model as jmodel
from jrender_tpu.nerf import trainer as jtrainer
from jrender_tpu.vol import camera as jcam
from jrender_tpu.vol import ray_marching as jrm
from jrender_tpu.vol import render_pass as jrp

from jrender_tpu_torch import convert
from jrender_tpu_torch.nerf import model as tmodel
from jrender_tpu_torch.nerf import trainer as ttrainer
from jrender_tpu_torch.ops.image import prefix_prod
from jrender_tpu_torch.vol import camera as tcam
from jrender_tpu_torch.vol import ray_marching as trm
from jrender_tpu_torch.vol import render_pass as trp

jint = importlib.import_module('jrender_tpu.vol.integrator')
tint = importlib.import_module('jrender_tpu_torch.vol.integrator')

COMPOSITE_TOL = 1e-6
MLP_TOL = 1e-5
BF16_OUT_TOL = 2e-3
BF16_GRAD_TOL = 3e-2
RENDER_TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def grad_err(jax_grads, params):
    """max |JAX - port| over a net's gradients, as a share of the net's
    largest gradient (a leaf whose entries are all small, as a density
    head's can be, is as far from JAX's as the sums it shares)."""
    pairs = list(zip(leaves(jax_grads), leaves(params)))
    scale = max(max(float(np.abs(np.asarray(a)).max()) for a, _ in pairs), 1e-30)
    return max(float(np.abs(np.asarray(a, np.float64) - b.grad.numpy()).max())
               for a, b in pairs) / scale


def jax_render_draws(key, N, n_samples, n_importance):
    """The four draws of the JAX ``render_rays`` for ``key`` (its split)."""
    k_sample, k_noise, k_pdf, k_noise2 = jax.random.split(key, 4)
    return {'t_rand': t(jax.random.uniform(k_sample, (N, n_samples))),
            'noise': t(jax.random.normal(k_noise, (N, n_samples))),
            'u': t(jax.random.uniform(k_pdf, (N, n_importance))),
            'noise2': t(jax.random.normal(k_noise2, (N, n_samples + n_importance)))}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


# -- camera ---------------------------------------------------------------------

@pytest.mark.parametrize('fn', ['pinhole_get_rays', 'get_rays'])
@pytest.mark.parametrize('intrinsic', [False, True])
def test_rays_equal_jax(fn, intrinsic):
    rng = np.random.RandomState(0)
    c2w = rng.randn(3, 4).astype(np.float32)
    K = None
    if intrinsic:
        K = np.linalg.inv(np.array([[20., 0, 8], [0, 21., 11], [0, 0, 1]])).astype(np.float32)
    jo, jd = getattr(jcam, fn)(22, 24, 20.5, jnp.asarray(c2w), None if K is None else jnp.asarray(K))
    to, td = getattr(tcam, fn)(22, 24, 20.5, t(c2w), K, )
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_ndc_rays_equal_jax():
    rng = np.random.RandomState(1)
    ro = rng.randn(64, 3).astype(np.float32)
    rd = rng.randn(64, 3).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    jo, jd = jcam.ndc_rays(16, 24, 20.5, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    to, td = tcam.ndc_rays(16, 24, 20.5, 1.0, t(ro), t(rd))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize('stop,num', [(1.0, 2), (1.0, 8), (1.0, 63), (1.0, 64), (1.0, 128),
                                      (9, 10), (23, 24), (41, 42), (399, 400), (47, 48)])
def test_linspace0_equals_jax(stop, num):
    np.testing.assert_array_equal(tcam.linspace0(stop, num).numpy(),
                                  np.asarray(jnp.linspace(0, stop, num), np.float32))


@pytest.mark.parametrize('n', [5, 14, 31, 33, 62, 64, 96, 127, 192])
def test_row_sum_and_prefix_prod_equal_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.rand(128, n) * rng.choice([1e-3, 1.0, 10.0], size=(128, n))).astype(np.float32)
    if n <= 64 or n % 32 in (0, 31):
        np.testing.assert_array_equal(tint.row_sum(t(x)).numpy(), np.asarray(jnp.sum(x, -1)))
    p = (1.0 - rng.rand(128, n) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(prefix_prod(t(p), -1).numpy(), np.asarray(jnp.cumprod(p, -1)))


# -- sampling and compositing -----------------------------------------------------

@pytest.mark.parametrize('lindisp', [False, True])
@pytest.mark.parametrize('perturb', [0.0, 1.0])
def test_sample_equals_jax(lindisp, perturb):
    rng = np.random.RandomState(2)
    near = rng.uniform(0.5, 2.0, (40, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 4.0, (40, 1)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    z = jint.sample(40, 16, lindisp, perturb, jnp.asarray(near), jnp.asarray(far), key)
    t_rand = t(jax.random.uniform(key, (40, 16)))
    zt = tint.sample(40, 16, lindisp, perturb, t(near), t(far), t_rand)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(z))


@pytest.mark.parametrize('n_bins,N', [(6, 8), (14, 16), (62, 128)])
@pytest.mark.parametrize('det', [True, False])
def test_sample_pdf_equals_jax(n_bins, N, det):
    """The bins agree: no sample changes its CDF bin (the count is printed)."""
    rng = np.random.RandomState(n_bins)
    bins = np.sort(rng.rand(256, n_bins).astype(np.float32) * 4 + 2, -1)
    w = (rng.rand(256, n_bins) ** 4).astype(np.float32)
    w[::7] = 0.0                                # rays that hit nothing
    key = jax.random.PRNGKey(3)
    j = np.asarray(jint.sample_pdf(jnp.asarray(bins), jnp.asarray(w), N, det, key))
    u = None if det else t(jax.random.uniform(key, (256, N)))
    got = tint.sample_pdf(t(bins), t(w), N, det, u).numpy()
    flips = sum(int((np.searchsorted(b, g, side='right') != np.searchsorted(b, x, side='right')).sum())
                for b, g, x in zip(bins, got, j))
    print(f'sample_pdf bins={n_bins} N={N} det={det}: {flips} samples changed bin, '
          f'{int((got != j).sum())} of {j.size} values differ')
    np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize('white_bkgd', [False, True])
@pytest.mark.parametrize('noise_std', [0.0, 0.7])
def test_integrator_equals_jax(white_bkgd, noise_std):
    rng = np.random.RandomState(4)
    raw = (rng.randn(64, 24, 4) * 2).astype(np.float32)
    raw[:4, :, 3] = -5.0                      # empty rays: acc 0, disp at its clamp
    z = np.sort(rng.rand(64, 24).astype(np.float32) * 4 + 2, -1)
    rd = rng.randn(64, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = t(jax.random.normal(key, (64, 24)))

    def jloss(r):
        out = jint.integrator(r, jnp.asarray(z), jnp.asarray(rd), noise_std, white_bkgd, key)
        return jnp.sum(out[0] ** 2) + jnp.sum(out[2]) + 0.1 * jnp.sum(out[4]), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(raw))
    rt = t(raw).requires_grad_()
    tout = tint.integrator(rt, t(z), t(rd), noise_std, white_bkgd, noise)
    (torch.sum(tout[0] ** 2) + torch.sum(tout[2]) + 0.1 * torch.sum(tout[4])).backward()
    errs = {name: rel_err(a, b.detach())
            for name, a, b in zip(('rgb', 'disp', 'acc', 'weights', 'depth'), jout, tout)}
    errs['grad'] = rel_err(jg, rt.grad)
    print('integrator, share of max:', errs)
    assert max(errs.values()) <= COMPOSITE_TOL, errs


# -- the MLP ------------------------------------------------------------------

@pytest.mark.parametrize('multires,dims', [(4, 3), (10, 3), (10, 4), (4, -1)])
def test_embedder_matches_jax(multires, dims):
    rng = np.random.RandomState(6)
    i = -1 if dims == -1 else 0
    dims = 3 if dims == -1 else dims
    x = rng.uniform(-1.5, 1.5, (500, dims)).astype(np.float32)
    jf, jch = jmodel.get_embedder(multires, i, dims)
    tf, tch = tmodel.get_embedder(multires, i, dims)
    assert jch == tch
    a, b = np.asarray(jf(jnp.asarray(x))), tf(t(x)).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=MLP_TOL)
    if i == 0:
        np.testing.assert_array_equal(tmodel.Embedder(max_freq_log2=multires - 1,
                                                      num_freqs=multires).freq_bands.numpy(),
                                      np.asarray(2.0 ** jnp.linspace(0.0, multires - 1, multires)))


def _mlp_case(case, W=32, D=3, key=0):
    use_viewdirs = case != 'no_viewdirs'
    dims = 4 if case == 'embed_depth' else 3
    _, input_ch = jmodel.get_embedder(6, 0, dims)
    input_ch_views = jmodel.get_embedder(3, 0)[1] if use_viewdirs else 0
    params = jmodel.init_nerf_params(jax.random.PRNGKey(key), D, W, input_ch, input_ch_views,
                                     4, (1,), use_viewdirs)
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (300, input_ch + input_ch_views)).astype(np.float32)
    return params, x, (input_ch, input_ch_views, (1,), use_viewdirs)


@pytest.mark.parametrize('case', ['viewdirs', 'no_viewdirs', 'embed_depth'])
def test_nerf_apply_and_grads_match_jax(case):
    params, x, cfg = _mlp_case(case)
    tree = jax.tree_util.tree_map(np.asarray, params)

    def jloss(p):
        out = jmodel.nerf_apply(p, jnp.asarray(x), *cfg)
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    net = convert.nerf_params_from_numpy(tree, device='cpu')
    assert net.skips == (1,) and net.use_viewdirs == cfg[3]
    tout = net(t(x))
    torch.sum(torch.sin(tout)).backward()
    e_out = rel_err(jout, tout.detach())
    e_grad = grad_err(jg, net.tree())
    print(f'nerf_apply {case}: outputs {e_out:.3g}, gradients {e_grad:.3g} of max')
    assert e_out <= MLP_TOL and e_grad <= MLP_TOL
    back = convert.nerf_params_to_numpy(net)
    for a, b in zip(leaves(tree), leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_bf16_matches_jax_bf16_and_f32():
    """bfloat16 operands, float32 sums: against JAX's bf16 path, and against
    float32 at ``tests/test_nerf.py``'s own bound."""
    embed_fn, input_ch = jmodel.get_embedder(10, 0)
    embeddirs_fn, input_ch_views = jmodel.get_embedder(4, 0)
    params = jmodel.init_nerf_params(jax.random.PRNGKey(1), 8, 64, input_ch, input_ch_views,
                                     5, (4,), True)
    mk = lambda dt: jtrainer.make_network_query_fn(  # noqa: E731
        embed_fn, embeddirs_fn, input_ch, input_ch_views, (4,), True, netchunk=4096,
        compute_dtype=dt)
    pts = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (64, 8, 3), minval=-1.0,
                                        maxval=1.0))
    vd = pts[:, 0, :] / np.linalg.norm(pts[:, 0, :], axis=-1, keepdims=True)

    def jloss(p):
        out = mk(jnp.bfloat16)(jnp.asarray(pts), jnp.asarray(vd), p)
        return jnp.sum(out ** 2), out

    (_, jbf), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    net = convert.nerf_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), 'cpu')
    tfn, _ = tmodel.get_embedder(10, 0)
    tdf, _ = tmodel.get_embedder(4, 0)
    mkt = lambda dt: ttrainer.make_network_query_fn(  # noqa: E731
        tfn, tdf, input_ch, input_ch_views, (4,), True, netchunk=4096, compute_dtype=dt)
    tbf = mkt(torch.bfloat16)(t(pts), t(vd), net)
    assert tbf.dtype == torch.float32
    torch.sum(tbf ** 2).backward()
    e_out = rel_err(jbf, tbf.detach())
    e_grad = grad_err(jg, net.tree())
    print(f'bf16 against JAX bf16: outputs {e_out:.3g}, gradients {e_grad:.3g} of max')
    assert e_out <= BF16_OUT_TOL and e_grad <= BF16_GRAD_TOL
    with torch.no_grad():
        o32 = mkt(None)(t(pts), t(vd), net).numpy()
    assert np.abs(o32 - tbf.detach().numpy()).mean() / (np.abs(o32).mean() + 1e-6) < 0.02


def test_load_weights_from_keras_matches_jax():
    rng = np.random.RandomState(0)
    D, W = 2, 16
    _, ch = jmodel.get_embedder(2)
    _, ch_d = jmodel.get_embedder(1)
    weights = []
    for i in range(D):
        weights += [rng.randn(ch if i == 0 else W, W).astype(np.float32),
                    rng.randn(W).astype(np.float32)]
    weights += [rng.randn(W, W).astype(np.float32), rng.randn(W).astype(np.float32)]
    weights += [rng.randn(ch_d + W, W // 2).astype(np.float32),
                rng.randn(W // 2).astype(np.float32)]
    weights += [rng.randn(W // 2, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    weights += [rng.randn(W, 1).astype(np.float32), rng.randn(1).astype(np.float32)]
    jnet = jmodel.NeRF(D=D, W=W, input_ch=ch, input_ch_views=ch_d, use_viewdirs=True,
                       key=jax.random.PRNGKey(0))
    jnet.load_weights_from_keras(weights)
    tnet = tmodel.NeRF(D=D, W=W, input_ch=ch, input_ch_views=ch_d, use_viewdirs=True)
    tnet.load_weights_from_keras(weights)
    np.testing.assert_array_equal(tnet.pts_linears[0].w.detach().numpy(), weights[0])
    np.testing.assert_array_equal(tnet.alpha_linear.b.detach().numpy(), weights[-1])
    for a, b in zip(leaves(jax.tree_util.tree_map(np.asarray, jnet.params)),
                    leaves(convert.nerf_params_to_numpy(tnet))):
        np.testing.assert_array_equal(a, b)
    x = rng.randn(9, ch + ch_d).astype(np.float32)
    assert rel_err(jnet(jnp.asarray(x)), tnet(t(x)).detach()) <= MLP_TOL


# -- render_rays and render -------------------------------------------------------

def _hier_setup(use_viewdirs=True, embed_depth=False, W=24, D=2):
    dims = 4 if embed_depth else 3
    embed_fn, input_ch = jmodel.get_embedder(4, 0, dims)
    embeddirs_fn, input_ch_views = (jmodel.get_embedder(2, 0) if use_viewdirs else (None, 0))
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    params = {'coarse': jmodel.init_nerf_params(k1, D, W, input_ch, input_ch_views, 5, (4,),
                                                use_viewdirs),
              'fine': jmodel.init_nerf_params(k2, D, W, input_ch, input_ch_views, 5, (4,),
                                              use_viewdirs)}
    for p in params.values():       # a density that is positive somewhere on every ray
        head, k = (p['alpha_linear'], 0) if use_viewdirs else (p['output_linear'], 3)
        head['b'] = head['b'].at[k].set(1.0)
    jq = jtrainer.make_network_query_fn(embed_fn, embeddirs_fn, input_ch, input_ch_views, (4,),
                                        use_viewdirs, netchunk=100)
    tfn, _ = tmodel.get_embedder(4, 0, dims)
    tdf = tmodel.get_embedder(2, 0)[0] if use_viewdirs else None
    tq = ttrainer.make_network_query_fn(tfn, tdf, input_ch, input_ch_views, (4,), use_viewdirs,
                                        netchunk=100)
    nets = convert.nerf_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), 'cpu')
    return params, jq, nets, tq


def _rays(N, seed=12, viewdirs=True):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    o[:, 2] += 3.5
    d = rng.uniform(-0.4, 0.4, (N, 3)).astype(np.float32)
    d[:, 2] = -1.0
    cols = [o, d, np.full((N, 1), 2.0, np.float32), np.full((N, 1), 5.0, np.float32)]
    if viewdirs:
        cols.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.concatenate(cols, -1)


@pytest.mark.parametrize('case', ['viewdirs', 'no_viewdirs_noise', 'embed_depth_lindisp'])
def test_render_rays_hierarchical_matches_jax(case):
    use_viewdirs = case == 'viewdirs'
    embed_depth = case.startswith('embed_depth')
    noise_std = 0.5 if case.endswith('noise') else 0.0
    lindisp = case.endswith('lindisp')
    params, jq, nets, tq = _hier_setup(use_viewdirs, embed_depth)
    N, Ns, Ni = 40, 8, 16
    batch = _rays(N, viewdirs=use_viewdirs)
    target = np.random.RandomState(13).rand(N, 3).astype(np.float32)
    key = jax.random.PRNGKey(21)
    kw = dict(N_samples=Ns, N_importance=Ni, perturb=1.0, white_bkgd=True, retraw=True,
              raw_noise_std=noise_std, lindisp=lindisp, embed_depth=embed_depth)

    def jloss(p):
        ret = jrm.render_rays(jnp.asarray(batch), p['coarse'], jq, network_fine=p['fine'],
                              key=key, **kw)
        loss = jnp.mean((ret['rgb_map'] - target) ** 2) + jnp.mean((ret['rgb0'] - target) ** 2)
        return loss, ret

    (jl, jret), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tret = trm.render_rays(t(batch), nets['coarse'], tq, network_fine=nets['fine'],
                           draws=jax_render_draws(key, N, Ns, Ni), **kw)
    tl = torch.mean((tret['rgb_map'] - t(target)) ** 2) + \
        torch.mean((tret['rgb0'] - t(target)) ** 2)
    tl.backward()
    errs = {k: rel_err(jret[k], tret[k].detach())
            for k in ('rgb_map', 'disp_map', 'acc_map', 'rgb0', 'disp0', 'acc0', 'raw')}
    errs['loss'] = abs(float(jl) - float(tl.detach())) / abs(float(jl))
    for part in ('coarse', 'fine'):
        errs[part + '_grad'] = grad_err(jg[part], nets[part].tree())
    print(f'render_rays {case}, share of max:', errs)
    assert max(errs.values()) <= RENDER_TOL, errs


@pytest.mark.parametrize('ndc', [False, True])
def test_render_full_image_matches_jax(ndc):
    """``render`` from a camera, chunked (JAX pads into ``lax.map``; the port
    loops over slices), deterministic (perturb 0)."""
    params, jq, nets, tq = _hier_setup(True)
    H, W, focal = 12, 16, 14.0
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 3.5
    kw = dict(N_samples=8, N_importance=8, perturb=0.0, use_viewdirs=True, white_bkgd=False)
    near, far = (0.0, 1.0) if ndc else (2.0, 5.0)
    j = jrp.render(H, W, focal, chunk=50, c2w=jnp.asarray(c2w), ndc=ndc, near=near, far=far,
                   network_fn=params['coarse'], network_fine=params['fine'],
                   network_query_fn=jq, **kw)
    with torch.no_grad():
        g = trp.render(H, W, focal, chunk=50, c2w=t(c2w), ndc=ndc, near=near, far=far,
                       network_fn=nets['coarse'], network_fine=nets['fine'],
                       network_query_fn=tq, **kw)
    for a, b in zip(j[:3], g[:3]):
        assert a.shape == tuple(b.shape)
        assert rel_err(a, b) <= RENDER_TOL
    assert set(j[3]) == set(g[3])
    for k in j[3]:
        assert rel_err(j[3][k], g[3][k]) <= RENDER_TOL, k


def test_batchify_draws_follow_their_rays():
    """Draws are sliced with their rays: chunked and whole renders agree."""
    _, _, nets, tq = _hier_setup(True)
    batch = t(_rays(30))
    gen = torch.Generator().manual_seed(3)
    draws = {'t_rand': torch.rand(30, 8, generator=gen), 'u': torch.rand(30, 8, generator=gen)}
    kw = dict(network_fn=nets['coarse'], network_fine=nets['fine'], network_query_fn=tq,
              N_samples=8, N_importance=8, perturb=1.0)
    with torch.no_grad():
        whole = trp.batchify_rays(batch, 64, draws=draws, **kw)
        parts = trp.batchify_rays(batch, 7, draws=draws, **kw)
    for k in whole:
        np.testing.assert_allclose(parts[k].numpy(), whole[k].numpy(), rtol=1e-6, atol=1e-6)
