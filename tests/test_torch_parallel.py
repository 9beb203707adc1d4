"""The port's parallel stack (``jrender_tpu_torch.parallel``) against the JAX
package, on the CPU.

One gloo world of 4 ranks (``torch.multiprocessing``, a file store in the
test's temporary directory) runs every case once, in
``tests/torch_parallel_ranks.py``, which imports no JAX; the tests hold its
results against JAX here.

  * Sharded SoftRas on the plain bands (a CPU input): 128 px over 4 ranks,
    strided and contiguous; 64 px over 2 ranks of a 2 x 2 mesh (B = 2, T =
    4) with the top-K truncation binding; 72 px over 2 with
    ``grad_mode='full'``, whose 16-px tile rows do not divide over the ranks
    (contiguous H / n-row bands, as the JAX oracle bands,
    render.py:116-118; ``test_band_plan_on_the_cpu`` has 48 px over 4 too);
    40 faces each.  The image and the gradients
    are held against the JAX single-device oracle
    (``jax_impl.soft_rasterize_fwd_jax`` / ``_bwd_jax``), which is what
    tests/test_parallel.py holds the JAX sharded path to, at that file's
    tolerances: 99% of the pixels within 2e-4, alpha within 2e-4
    everywhere, gradients within 2e-3 of their max (rtol 2e-3).  They are
    also held against the port's one-device ``soft_rasterize`` on the CPU:
    the image within 1e-6, the gradients within 1e-5 of their max.  At
    72 px the port's one-device alpha is itself up to 5.5e-4 from the
    oracle's on 0.6% of the pixels (a pixel centre (2c + 1 - 72) / 72 is
    not exact; XLA divides through the reciprocal, PyTorch rounds the
    quotient once), so an alpha beyond 2e-4 counts there only where the
    one-device alpha is nearer the oracle's.  T = 4
    textures have texel i equal to texel T-1-i and their gradients are
    folded over each such pair (``utils/checks.py``: the texel selector's
    diagonal tie).  ``grad_mode='full'`` is held against the oracle at K =
    F (the oracle always truncates).  Every rank must return the same
    image and gradients.
  * ``band_row_src`` equals the JAX package's.
  * The binned kernels' band-aware plain versions (``cuda_impl.prepare``
    with a band, ``fwd_split_plain``, ``thr_split_plain``,
    ``bwd_rows_plain``, ``reduce_rows_plain``): each band's maps equal the
    whole image's rows and its slot rows the whole image's, bit for bit;
    the bands' gradients summed lie within 1e-5 of the whole image's max.
  * NeRF on a 2 data x 2 model world: the placement of every weight equals
    the JAX package's ``shard_nerf_params`` spec by spec (all replicated),
    and three steps of ``make_sharded_nerf_step`` (D = 2, W = 64, 64 rays, 8
    + 8 samples) match JAX's on a 2 x 2 CPU mesh and the port's one-device
    steps: the loss within 1e-5 relative, the weights within 1e-2 * lrate
    (tests/test_torch_nerf_train.py has why a share of lrate).  The port's
    one-device steps are themselves 0.066 * lrate from JAX's at one weight
    (coarse ``pts_linears[1]['w'][24, 24]``, whose first gradient, 8.0e-7,
    is eight times Adam's eps, so the last bits of the gradient move its
    updates), so against JAX a weight counts beyond the bound only by what
    exceeds the one-device steps' own distance.
"""
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jrender_tpu.nerf import trainer as jtrainer
from jrender_tpu.ops.softras import jax_impl
from jrender_tpu.ops.softras import make_params as jax_params
from jrender_tpu.parallel import mesh as jmesh
from jrender_tpu.parallel import nerf as jnerf
from jrender_tpu.parallel import render as jrender

from jrender_tpu_torch import convert
from jrender_tpu_torch.nerf import trainer as ttrainer
from jrender_tpu_torch.nerf.model import img2mse
from jrender_tpu_torch.ops.softras import binning, cuda_impl, make_params, soft_rasterize
from jrender_tpu_torch.parallel import band_row_src
from jrender_tpu_torch.parallel import render as trender
from jrender_tpu_torch.utils.checks import fold_ties, tie_symmetric
from jrender_tpu_torch.vol.ray_marching import render_rays

import torch_parallel_ranks
from conftest import make_random_mesh

torch.set_num_threads(2)

WORLD = 4
F = 40
FWD_ATOL = 2e-4           # tests/test_parallel.py's image tolerance
FWD_FRAC = 0.01
GRAD_TOL = 2e-3           # and its gradient tolerance (atol of the max, rtol)
BAND_SUM_TOL = 1e-5       # bands' summed gradients against the whole image's
STEP_REL = 1e-5
PARAM_LR_SHARE = 1e-2

# name: (seed, image size, data ranks, band mode, batch, texels, K, grad mode)
RASTER = {
    'is128_n4_stride': (1, 128, 4, 'stride', 1, 1, 8, 'topk'),
    'is128_n4_contig': (1, 128, 4, 'contig', 1, 1, 8, 'topk'),
    'is64_n2_B2_T4': (2, 64, 2, 'stride', 2, 4, 16, 'topk'),
    'is72_n2_rows_full': (4, 72, 2, 'stride', 1, 1, 8, 'full'),
}

NERF_ARGS = dict(netdepth=2, netwidth=64, netdepth_fine=2, netwidth_fine=64, N_rand=64,
                 lrate=5e-3, lrate_decay=250, chunk=4096, netchunk=4096, no_batching=True,
                 no_reload=True, ft_path=None, N_iters=3, N_samples=8, N_importance=8,
                 perturb=0.0, use_viewdirs=True, i_embed=0, multires=4, multires_views=2,
                 raw_noise_std=0.0, precrop_iters=0, precrop_frac=0.5, dataset_type='blender',
                 white_bkgd=True, lindisp=False, no_ndc=True, seed=0, basedir='unused',
                 expname='x', steps_per_dispatch=1, accumulation_steps=1, valid_ratio=-1.0,
                 net_precision='f32', embed_depth=False)
NERF_STEPS = 3


def raster_case(name):
    seed, is_, n, mode, B, T, K, grad_mode = RASTER[name]
    rng = np.random.RandomState(seed)
    fv = np.stack([make_random_mesh(rng, num_faces=F).reshape(F, 9) for _ in range(B)])
    tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
    if T > 1:
        tex = tie_symmetric(tex).astype(np.float32)
    params = dict(image_size=is_, sigma_val=1e-3, gamma_val=1e-3,
                  max_faces_per_pixel_for_grad=K, grad_mode=grad_mode)
    g = rng.randn(B, 4, is_, is_).astype(np.float32)
    return dict(fv=fv, tex=tex, params=params, g=g, n=n, mode=mode)


def nerf_rays(rng, n=64):
    ro = np.array([0.0, 0.0, 4.0]) + rng.uniform(-0.3, 0.3, (n, 3))
    rd = -ro / np.linalg.norm(ro, axis=1, keepdims=True) + rng.uniform(-0.2, 0.2, (n, 3))
    vd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    rays = np.concatenate([ro, rd, np.full((n, 1), 2.0), np.full((n, 1), 6.0), vd], 1)
    return rays.astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The cases (the NeRF's initial weights the port's), the 4 ranks'
    results and JAX's (computed while the ranks run): the oracle of each
    raster case, and the sharded NeRF's specs, losses and weights."""
    d = tmp_path_factory.mktemp('world')
    nets = ttrainer.create_nerf(SimpleNamespace(**NERF_ARGS), device='cpu')[3]
    rays, target = nerf_rays(np.random.RandomState(5))
    cases = {'raster': {name: raster_case(name) for name in RASTER},
             'nerf': dict(n_data=2, args=NERF_ARGS, steps=NERF_STEPS, rays=rays, target=target,
                          params=convert.nerf_params_to_numpy(nets))}
    with open(d / 'cases.pkl', 'wb') as f:
        pickle.dump(cases, f)
    ranks = torch.multiprocessing.spawn(torch_parallel_ranks.run_rank,
                                        args=(WORLD, str(d / 'store'), str(d / 'cases.pkl')),
                                        nprocs=WORLD, join=False)
    try:
        oracle = {}
        for name in cases['raster']:
            # one oracle for cases that differ in their band mode only
            twin = name.replace('_contig', '_stride')
            oracle[name] = oracle.get(twin) or jax_oracle(cases['raster'][twin])
        jax_side = {'oracle': oracle, 'nerf': jax_nerf(cases['nerf'])}
    finally:
        while not ranks.join():
            pass
    return cases, torch_parallel_ranks.load_results(str(d), WORLD), jax_side


def jax_oracle(case):
    """(image, grad_face, grad_textures) of the JAX single-device oracle;
    ``grad_mode='full'`` as the oracle at K = F."""
    kw = dict(case['params'])
    if kw.pop('grad_mode') == 'full':
        kw['max_faces_per_pixel_for_grad'] = F
    p = jax_params(**kw)
    fv, tex = jnp.asarray(case['fv']), jnp.asarray(case['tex'])
    out, ag, fid = jax_impl.soft_rasterize_fwd_jax(fv, tex, p)
    gf, gt = jax_impl.soft_rasterize_bwd_jax(fv, tex, out, ag, fid, jnp.asarray(case['g']), p)
    return np.asarray(out), np.asarray(gf), np.asarray(gt)


def port_single(case):
    """(image, grad_face, grad_textures) of the port's one-device
    ``soft_rasterize`` on the CPU."""
    fv = torch.tensor(case['fv'], requires_grad=True)
    tex = torch.tensor(case['tex'], requires_grad=True)
    kw = dict(case['params'])
    kw['max_faces_per_pixel_for_grad'] = kw.pop('max_faces_per_pixel_for_grad')
    img = soft_rasterize(fv, tex, device='cpu', **kw)
    (img * torch.tensor(case['g'])).sum().backward()
    return img.detach().numpy(), fv.grad.numpy(), tex.grad.numpy()


def assert_grad_close(got, want):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale, rtol=GRAD_TOL)


@pytest.mark.parametrize('name', sorted(RASTER))
def test_sharded_soft_rasterize_matches_oracle(world, name):
    cases, results, jax_side = world
    case = cases['raster'][name]
    out, gf_ref, gt_ref = jax_side['oracle'][name]
    mine = results[0]['raster'][name]
    for r in range(1, WORLD):            # every rank holds the whole image and gradients
        for k in ('image', 'gf', 'gt'):
            np.testing.assert_array_equal(results[r]['raster'][name][k], mine[k])
    img = mine['image']
    assert img.shape == out.shape and np.isfinite(img).all()
    # against the port's one-device path: the bands change the order of
    # the gradients' sums only
    img1, gf1, gt1 = port_single(case)
    np.testing.assert_allclose(img, img1, atol=1e-6, rtol=0)
    for got, want in ((mine['gf'], gf1), (mine['gt'], gt1)):
        np.testing.assert_allclose(got, want, atol=BAND_SUM_TOL * np.abs(want).max(), rtol=0)
    # against the oracle; an alpha beyond 2e-4 counts unless the port's
    # one-device alpha is as far (72 px: see the module docstring)
    assert (np.abs(img - out) > FWD_ATOL).mean() < FWD_FRAC
    d, d1 = np.abs(img[:, 3] - out[:, 3]), np.abs(img1[:, 3] - out[:, 3])
    assert not ((d > FWD_ATOL) & (d1 < d - 1e-6)).any(), d.max()
    assert_grad_close(mine['gf'], gf_ref.reshape(mine['gf'].shape))
    gt, gt_ref = mine['gt'], gt_ref.reshape(mine['gt'].shape)
    if gt.shape[2] > 1:
        gt, gt_ref = fold_ties(gt), fold_ties(gt_ref)
    assert_grad_close(gt, gt_ref)
    assert np.abs(mine['gf']).max() > 0


def test_stride_equals_contig(world):
    """The strided bands, put back in image order, give the contiguous
    bands' image and gradients (test_parallel.py's
    ``test_pxt_stride_equals_contig``)."""
    _, results, _ = world
    s, c = results[0]['raster']['is128_n4_stride'], results[0]['raster']['is128_n4_contig']
    np.testing.assert_allclose(s['image'], c['image'], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(s['gf'], c['gf'], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s['gt'], c['gt'], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('is_,n,mode,route,strided,rows', [
    (128, 4, 'stride', 'plain', True, 32), (128, 4, 'contig', 'plain', False, 32),
    (64, 2, 'stride', 'plain', True, 32), (72, 2, 'stride', 'plain', False, 36),
    (48, 4, 'stride', 'plain', False, 12), (64, 1, 'stride', 'plain', False, 64)])
def test_band_plan_on_the_cpu(is_, n, mode, route, strided, rows):
    """The CPU's bands as the JAX oracle's (render.py:115-125): strided over
    16-px tile rows where they divide over the ranks, else contiguous."""
    plan = trender.band_plan(make_params(image_size=is_), n, 'cpu', mode)
    assert (plan.route, plan.strided, plan.rows) == (route, strided, rows)
    covered = torch.cat([trender.band_image_rows(plan, r) for r in range(n)])
    assert sorted(covered.tolist()) == list(range(is_))


@pytest.mark.parametrize('is_,n,tile', [(128, 4, 16), (128, 8, 16), (64, 2, 16), (1024, 8, 16),
                                        (256, 4, 32)])
def test_band_row_src_equals_jax(is_, n, tile):
    src, inv = band_row_src(is_, n, tile)
    jsrc, jinv = jrender.band_row_src(is_, n, tile)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(inv, jinv)
    plan = trender.BandPlan('plain', n, True, tile, is_ // n)
    bands = torch.cat([trender.band_image_rows(plan, r) for r in range(n)]).numpy()
    np.testing.assert_array_equal(bands, src)


def test_mesh_helpers(world):
    """``shard_batch`` takes the 'data' coordinate's share and refuses a size
    that does not divide; ``replicate`` leaves every rank with the first
    rank's values."""
    _, results, _ = world
    for r, res in enumerate(results):
        m = res['mesh']
        d, k = m['coords']
        assert (d, k) == divmod(r, 2)
        np.testing.assert_array_equal(m['shard'][:, 0], np.arange(4.0) + 4 * d)
        np.testing.assert_array_equal(m['shard_axis1'],
                                      np.arange(12.0).reshape(3, 4)[:, 2 * d:2 * d + 2])
        assert m['shard_refuses']
        np.testing.assert_array_equal(m['replicated'][0], np.zeros(3))
        np.testing.assert_array_equal(m['replicated'][1], np.full(2, 10.0))


def _leaves(tree):
    """The leaves of a tree of dicts (keys sorted, as JAX orders them) and
    lists; a tuple is a leaf (a spec)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]

def jax_nerf(case):
    """JAX's sharded NeRF on a 2 x 2 CPU mesh from the case's weights: the
    weights' specs, the losses and the weights after the steps."""
    args = SimpleNamespace(**NERF_ARGS)
    rk, _, _, _, opt, _ = jtrainer.create_nerf(args, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, case['params'])
    opt_state = opt.init(params)
    mesh = jmesh.make_device_mesh(n_data=2, n_model=2)
    params = jnerf.shard_nerf_params(params, mesh)
    specs = jax.tree_util.tree_map(lambda a: tuple(a.sharding.spec), params)
    step = jnerf.make_sharded_nerf_step(opt, rk['network_query_fn'], mesh,
                                        N_samples=args.N_samples,
                                        N_importance=args.N_importance,
                                        white_bkgd=args.white_bkgd)
    losses = []
    rays, target = jnp.asarray(case['rays']), jnp.asarray(case['target'])
    for _ in range(NERF_STEPS):
        params, opt_state, loss = step(params, opt_state, rays, target, None)
        losses.append(float(loss))
    return specs, losses, jax.tree_util.tree_map(np.asarray, params)


def test_nerf_param_specs_match_jax(world):
    """The placement of every weight, leaf by leaf: the JAX rule never
    matches a NeRF leaf's name, so every one is replicated."""
    _, results, jax_side = world
    specs, _, _ = jax_side['nerf']
    jleaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    for res in results:
        tleaves = _leaves(res['nerf']['specs'])
        assert len(tleaves) == len(jleaves) > 0
        assert [tuple(s) for s in tleaves] == [tuple(s) for s in jleaves]
        assert all(s == () for s in tleaves)


def port_nerf_steps(case):
    """The port's one-device steps (no ranks) from the same weights: the
    losses and the weights after them."""
    args = SimpleNamespace(**NERF_ARGS)
    kwargs, _, _, nets, opt = ttrainer.create_nerf(args, device='cpu')
    nets.load_state_dict(convert.nerf_params_from_numpy(case['params'], 'cpu').state_dict())
    rays, target = torch.tensor(case['rays']), torch.tensor(case['target'])
    losses = []
    for _ in range(NERF_STEPS):
        out = render_rays(rays, nets['coarse'], kwargs['network_query_fn'], args.N_samples,
                          N_importance=args.N_importance, network_fine=nets['fine'],
                          white_bkgd=args.white_bkgd)
        loss = img2mse(out['rgb_map'], target) + img2mse(out['rgb0'], target)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses, jax.tree_util.tree_leaves(convert.nerf_params_to_numpy(nets))


def test_sharded_nerf_step_matches_jax(world):
    cases, results, jax_side = world
    _, jlosses, jparams = jax_side['nerf']
    lrate = NERF_ARGS['lrate']
    init = jax.tree_util.tree_leaves(cases['nerf']['params'])
    jl = jax.tree_util.tree_leaves(jparams)
    ol, one = port_nerf_steps(cases['nerf'])
    for res in results:                       # the model ranks hold the same copies
        for a, b, c in zip(res['nerf']['losses'], jlosses, ol):
            assert abs(a - b) <= STEP_REL * abs(b), (res['nerf']['losses'], jlosses)
            assert abs(a - c) <= STEP_REL * abs(c), (res['nerf']['losses'], ol)
        tl = jax.tree_util.tree_leaves(res['nerf']['params'])
        assert len(tl) == len(jl) == len(one)
        # against the port's one-device steps: the shares change the order
        # of the gradients' sums only
        err_one = max(float(np.abs(a - b).max()) for a, b in zip(tl, one)) / lrate
        # against JAX: a weight beyond the bound counts unless the port's
        # one-device steps are as far (see the module docstring)
        unexplained = max(float((np.abs(a - b) - np.abs(c - b)).max())
                          for a, b, c in zip(tl, jl, one)) / lrate
        moved = max(float(np.abs(a - b).max()) for a, b in zip(tl, init)) / lrate
        assert moved > 1.0 and err_one <= PARAM_LR_SHARE and unexplained <= PARAM_LR_SHARE, \
            (err_one, unexplained, moved)
    for res in results[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(res['nerf']['params']),
                        jax.tree_util.tree_leaves(results[0]['nerf']['params'])):
            np.testing.assert_array_equal(a, b)


# -- the binned kernels' band-aware plain versions -----------------------------------

def _band_case(seed, mt):
    rng = np.random.RandomState(seed)
    fv = torch.tensor(make_random_mesh(rng, num_faces=F).reshape(1, F, 9))
    tex = tie_symmetric(torch.tensor(rng.uniform(size=(1, F, 4, 3)).astype(np.float32)))
    p = make_params(image_size=128, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=4)

    def inputs(band):
        x = cuda_impl.prepare(fv, tex, p, for_grad=True, band=band)
        if mt is not None:     # a small emit cap: faces over mt tiles are big
            x = x._replace(lists=binning.build_tile_lists_compact(
                fv, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt,
                with_inverse=True, band=band))
        return x
    return fv, tex, p, inputs


@pytest.mark.parametrize('n,mode,mt', [(4, 'stride', None), (4, 'stride', 2),
                                       (4, 'contig', 2), (2, 'stride', 2)])
def test_band_plain_versions_equal_the_whole_image(n, mode, mt):
    """Each band's maps, threshold and slot rows are the whole image's, bit
    for bit; the bands' gradients summed are the whole image's within 1e-5
    of its max."""
    fv, tex, p, inputs = _band_case(11, mt)
    whole = inputs(None)
    img, ag, cnt = cuda_impl.fwd_split_plain(whole, p)
    thr = cuda_impl.thr_split_plain(whole, cnt, p)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(3))
    rows_w = cuda_impl.bwd_rows_plain(whole, img, ag, thr, g, p)
    gf_w, gt_w = cuda_impl.reduce_rows_plain(whole, rows_w, p)
    if mt is not None:
        assert int(whole.lists.gcount.sum()) > 0
    plan = trender.BandPlan('binned', n, mode == 'stride', 16, 128 // n)
    gf_s, gt_s = torch.zeros_like(gf_w), torch.zeros_like(gt_w)
    for r in range(n):
        band = trender.band_of(plan, r)
        x = inputs(band)
        rows = cuda_impl.band_rows(128, band)
        assert torch.equal(rows, trender.band_image_rows(plan, r))
        bi, ba, bc = cuda_impl.fwd_split_plain(x, p)
        bt = cuda_impl.thr_split_plain(x, bc, p)
        for got, want in ((bi, img), (ba, ag), (bc, cnt), (bt, thr)):
            assert torch.equal(got, want.index_select(-2, rows))
        rows_b = cuda_impl.bwd_rows_plain(x, bi, ba, bt, g[:, :, rows], p)
        sb, sw = x.lists.gsrc, whole.lists.gsrc
        emitted = sb >= 0
        assert bool((sw[emitted] >= 0).all())
        assert torch.equal(rows_b.gslots[0, sb[emitted]], rows_w.gslots[0, sw[emitted]])
        gf, gt = cuda_impl.reduce_rows_plain(x, rows_b, p)
        gf_s, gt_s = gf_s + gf, gt_s + gt
    for got, want in ((gf_s, gf_w), (fold_ties(gt_s), fold_ties(gt_w))):
        assert (got - want).abs().max() <= BAND_SUM_TOL * want.abs().max()


def test_band_lists_keep_the_band_runs():
    """A band's lists hold the whole image's runs on its tiles, none
    elsewhere, and the whole big-face list."""
    fv, tex, p, inputs = _band_case(12, 2)
    whole = inputs(None).lists
    band = (1, 2, 4)
    cl = inputs(band).lists
    assert cl.band == band and torch.equal(cl.glist, whole.glist)
    for t in range(64):
        run = cl.faces_sorted[0, cl.starts[0, t]:cl.starts[0, t] + cl.run_counts[0, t]]
        want = whole.faces_sorted[0, whole.starts[0, t]:whole.starts[0, t]
                                  + whole.run_counts[0, t]]
        in_band = t // 8 in (1, 5)
        assert torch.equal(run, want) if in_band else run.numel() == 0
    with pytest.raises(ValueError):
        cuda_impl.prepare(fv, tex, p, band=(1, 2, 8))


@pytest.mark.parametrize('is_,band', [(128, None), (128, (1, 2, 4)), (128, (2, 3, 1)),
                                      (72, (4, 1, 1)), (72, (1, 2, 3)), (72, (0, 3, 2))])
def test_band_args_give_the_kernels_the_band(is_, band, monkeypatch):
    """The binned kernels' argument builders on a band, the CPU standing in
    for the card: band-local outputs of ``band_height`` rows (a band over
    a ragged last tile row included) and the band in the struct."""
    monkeypatch.setattr(cuda_impl, '_need_cuda', lambda dev: None)
    rng = np.random.RandomState(13)
    fv = torch.tensor(make_random_mesh(rng, num_faces=F).reshape(1, F, 9))
    tex = torch.rand(1, F, 4, 3, generator=torch.Generator().manual_seed(13))
    p = make_params(image_size=is_, max_faces_per_pixel_for_grad=4)
    x = cuda_impl.prepare(fv, tex, p, for_grad=True, band=band)
    want = band or cuda_impl.full_band(is_)
    Hb = cuda_impl.band_height(is_, want)
    assert Hb == cuda_impl.band_rows(is_, band).numel()
    fa, (img, ag, cnt) = cuda_impl.fwd_args(x, p)
    ta, thr = cuda_impl.thr_args(x, cnt, p)
    ba, _ = cuda_impl.bwd_args(x, img, ag, thr, torch.zeros_like(img), p)
    assert img.shape == (1, 4, Hb, is_) and thr.shape == (1, Hb, is_)
    for args in (fa, ta, ba):
        assert (args.ty0, args.ty_band, args.ty_stride, args.band_h) == (*want, Hb)
        assert args.tiles_y == -(-is_ // 16)
    with pytest.raises(ValueError):
        cuda_impl.bwd_args(x, img[:, :, :Hb - 1], ag, thr, torch.zeros_like(img), p)
