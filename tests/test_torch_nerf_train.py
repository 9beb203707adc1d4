"""The port's NeRF trainer, config, datasets and profiling
(``jrender_tpu_torch.nerf``, ``jrender_tpu_torch.utils.profiling``) against
the JAX package on the CPU, and its own end-to-end runs.

Tolerances:
  * ``parse_args`` on every ``configs/*.txt``: equal namespaces;
  * the loaders: images, poses, render poses, hwf and splits equal (both
    read the same PNGs; ``_minify`` resizes with the same PIL filter);
  * the train step against JAX's ``make_train_step`` /
    ``make_batched_train_step``, fed JAX's draws, from the same weights:
    loss and PSNR within 1e-5 relative at every step, and the weights after
    three updates within 1e-2 · lrate (read: at most 2.8e-3 · lrate).
    Adam's first steps move each weight by about lrate · g / (|g| + eps):
    where a gradient is near 0 a difference in its last bits moves the
    update by a share of lrate (the worst weight of the first update read
    a gradient of 1.7e-9, 60 times below eps, and moved by 0.0167 · lrate
    in JAX and 0.0180 · lrate in the port), so the bound is a share of
    lrate;
  * the learning rate: optax's ``exponential_decay`` within 1e-7 relative
    (both in float32);
  * a run resumed from its checkpoint equals the straight run to the bit.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jrender_tpu.nerf import config as jconfig
from jrender_tpu.nerf import dataset as jdata
from jrender_tpu.nerf import trainer as jtrainer

from jrender_tpu_torch import convert
from jrender_tpu_torch.io import image as image_io
from jrender_tpu_torch.nerf import config as tconfig
from jrender_tpu_torch.nerf import dataset as tdata
from jrender_tpu_torch.nerf import trainer as ttrainer
from jrender_tpu_torch.utils import profiling

from test_nerf_train_e2e import make_blender_dataset, make_dv_dataset, make_llff_dataset
from test_torch_nerf import jax_render_draws, leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_REL = 1e-5
PARAM_LR_SHARE = 1e-2


def t(x):
    return torch.from_numpy(np.array(x))


# -- config ---------------------------------------------------------------------

CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, 'configs')) if f.endswith('.txt'))


@pytest.mark.parametrize('name', CONFIGS)
def test_parse_args_equals_jax(name):
    path = os.path.join(REPO, 'configs', name)
    argv = ['--config', path, '--N_iters', '7', '--white_bkgd']
    assert vars(tconfig.parse_args(argv)) == vars(jconfig.parse_args(argv))


# -- loaders ----------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize('kw', [dict(), dict(half_res=True), dict(testskip=2),
                                dict(do_pose_normalization=True, target_radius=2.0)])
def test_load_blender_equals_jax(tmp_path, kw):
    root = str(tmp_path / 'b')
    make_blender_dataset(root, n=4)
    _same(jdata.load_blender_data(root, **kw), tdata.load_blender_data(root, **kw))


@pytest.mark.parametrize('factor,spherify', [(1, False), (1, True), (2, False)])
def test_load_llff_equals_jax(tmp_path, factor, spherify):
    """Each package loads its own copy of the scene, so at factor 2 each
    ``_minify`` writes its own ``images_2``."""
    make_llff_dataset(str(tmp_path / 'j'))
    shutil.copytree(tmp_path / 'j', tmp_path / 't')
    j = jdata.load_llff_data(str(tmp_path / 'j'), factor=factor, spherify=spherify)
    g = tdata.load_llff_data(str(tmp_path / 't'), factor=factor, spherify=spherify)
    _same(j, g)
    if factor > 1:
        names = sorted(os.listdir(tmp_path / 'j' / 'images_2'))
        assert names == sorted(os.listdir(tmp_path / 't' / 'images_2'))
        for n in names:
            np.testing.assert_array_equal(image_io.read_raw(tmp_path / 't' / 'images_2' / n),
                                          image_io.read_raw(tmp_path / 'j' / 'images_2' / n))


def test_minify_resolution_equals_jax(tmp_path):
    make_llff_dataset(str(tmp_path / 'j'))
    shutil.copytree(tmp_path / 'j', tmp_path / 't')
    jdata._minify(str(tmp_path / 'j'), resolutions=[[12, 20]])
    tdata._minify(str(tmp_path / 't'), resolutions=[[12, 20]])
    for n in sorted(os.listdir(tmp_path / 'j' / 'images_20x12')):
        np.testing.assert_array_equal(image_io.read_raw(tmp_path / 't' / 'images_20x12' / n),
                                      image_io.read_raw(tmp_path / 'j' / 'images_20x12' / n))


def test_load_dv_equals_jax(tmp_path):
    root = str(tmp_path / 'dv')
    make_dv_dataset(root, n=4)
    _same(jdata.load_dv_data('cube', root, testskip=2), tdata.load_dv_data('cube', root, testskip=2))


def test_pose_helpers_equal_jax():
    rng = np.random.RandomState(0)
    _same(jdata.pose_spherical(33.0, -30.0, 4.0), tdata.pose_spherical(33.0, -30.0, 4.0))
    poses = rng.randn(6, 3, 5)
    _same(jdata._recenter_poses(poses), tdata._recenter_poses(poses))
    _same(jdata._render_path_spiral(poses[0], np.array([0, 1.0, 0]), [0.3, 0.2, 0.1], 3.0, 0.1,
                                    0.5, 2, 10),
          tdata._render_path_spiral(poses[0], np.array([0, 1.0, 0]), [0.3, 0.2, 0.1], 3.0, 0.1,
                                    0.5, 2, 10))


# -- the step against JAX ---------------------------------------------------------

def _args(**kw):
    base = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, N_rand=64,
                lrate=5e-3, lrate_decay=250, chunk=4096, netchunk=4096, no_batching=True,
                no_reload=True, ft_path=None, N_iters=3, N_samples=8, N_importance=8,
                perturb=1.0, use_viewdirs=True, i_embed=0, multires=4, multires_views=2,
                raw_noise_std=0.0, precrop_iters=0, precrop_frac=0.5, dataset_type='blender',
                white_bkgd=True, lindisp=False, no_ndc=True, seed=0, basedir='unused',
                expname='x', steps_per_dispatch=1, accumulation_steps=1, valid_ratio=-1.0,
                net_precision='f32', embed_depth=False)
    base.update(kw)
    return SimpleNamespace(**base)


STEP_CASES = {
    'plain': dict(),
    'precrop_noise': dict(precrop_iters=10, raw_noise_std=0.5),
    'mask_guided': dict(valid_ratio=0.8),
    'batched': dict(no_batching=False),
    'accumulate': dict(accumulation_steps=2),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_train_step_matches_jax(tmp_path, case):
    """Three updates of both packages from the same weights on the same
    pixels and draws (JAX's, fed to the port)."""
    args = _args(**STEP_CASES[case])
    root = str(tmp_path / 'data')
    make_blender_dataset(root, n=3)
    images, poses, _, (H, W, focal), _ = jdata.load_blender_data(root, testskip=1)
    masks = images[..., -1:]
    images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    H, W = int(H), int(W)
    acc = args.accumulation_steps
    n_rand = args.N_rand // acc
    near, far = 2.0, 6.0

    rk_j, _, _, params, opt, opt_state = jtrainer.create_nerf(args, jax.random.PRNGKey(0))
    rk_j.pop('ndc', None)
    rk_t, _, _, nets, topt = ttrainer.create_nerf(args, device='cpu')
    rk_t.pop('ndc', None)
    nets.load_state_dict(convert.nerf_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), 'cpu').state_dict())

    key = jax.random.PRNGKey(7)
    losses = []
    if case == 'batched':
        pool = jtrainer.build_ray_pool(images, poses, [0, 1, 2], H, W, focal)
        np.testing.assert_allclose(ttrainer.build_ray_pool(images, poses, [0, 1, 2], H, W, focal),
                                   pool, rtol=0, atol=1e-6)
        perm = jax.random.permutation(jax.random.PRNGKey(1), pool.shape[0])
        jstep = jax.jit(jtrainer.make_batched_train_step(opt, rk_j, H, W, focal, near, far,
                                                         n_rand, False))
        tstep = ttrainer.make_batched_train_step(topt, rk_t, H, W, focal, near, far, n_rand, False)
        for s in range(3 * acc):
            k = jax.random.fold_in(key, s)
            params, opt_state, jl, jp = jstep(params, opt_state, jnp.asarray(pool), perm,
                                              s * n_rand, k)
            tl, tp = tstep(nets, t(pool), t(perm), s * n_rand,
                           draws=jax_render_draws(k, n_rand, 8, 8))
            losses.append((float(jl), float(tl), float(jp), float(tp)))
    else:
        jstep = jax.jit(jtrainer.make_train_step(opt, rk_j, H, W, focal, near, far, n_rand,
                                                 args.precrop_iters, args.precrop_frac, False,
                                                 valid_ratio=args.valid_ratio))
        tstep = ttrainer.make_train_step(topt, rk_t, H, W, focal, near, far, n_rand,
                                         args.precrop_iters, args.precrop_frac, False,
                                         valid_ratio=args.valid_ratio)
        use_mask = args.valid_ratio >= 0
        for s in range(3 * acc):
            i = s % 3
            k = jax.random.fold_in(key, s)
            k_sel, k_render = jax.random.split(k)
            draws = jax_render_draws(k_render, n_rand, 8, 8)
            if use_mask:
                draws['gumbel'] = t(jax.random.gumbel(k_sel, (H * W,)))
            else:
                dH, dW = int(H // 2 * args.precrop_frac), int(W // 2 * args.precrop_frac)
                draws['hy'] = t(jax.random.randint(k_sel, (n_rand,), 0, 2 * dH))
                draws['hx'] = t(jax.random.randint(jax.random.fold_in(k_sel, 1), (n_rand,), 0,
                                                   2 * dW))
                draws['fy'] = t(jax.random.randint(jax.random.fold_in(k_sel, 2), (n_rand,), 0, H))
                draws['fx'] = t(jax.random.randint(jax.random.fold_in(k_sel, 3), (n_rand,), 0, W))
            mask = jnp.asarray(masks[i]) if use_mask else None
            params, opt_state, jl, jp = jstep(params, opt_state, jnp.asarray(images[i]),
                                              jnp.asarray(poses[i][:3, :4]), s, k, mask)
            tl, tp = tstep(nets, t(images[i]), t(poses[i][:3, :4]), s, draws=draws,
                           mask=t(masks[i]) if use_mask else None)
            losses.append((float(jl), float(tl), float(jp), float(tp)))
    for jl, tl, jp, tp in losses:
        assert abs(jl - tl) <= STEP_REL * abs(jl) and abs(jp - tp) <= STEP_REL * abs(jp), losses
    assert topt.count == 3
    jleaves = leaves(jax.tree_util.tree_map(np.asarray, params))
    tleaves = leaves(convert.nerf_params_to_numpy(nets))
    err = max(float(np.abs(a - b).max()) for a, b in zip(jleaves, tleaves)) / args.lrate
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        tleaves, leaves(jax.tree_util.tree_map(np.asarray, jtrainer.create_nerf(
            args, jax.random.PRNGKey(0))[3]))))
    print(f'step {case}: weights within {err:.3g} of lrate after 3 updates '
          f'(moved up to {moved / args.lrate:.3g} lrate)')
    assert moved > args.lrate
    assert err <= PARAM_LR_SHARE


def test_mask_guided_selection_tiers():
    """The mask-guided choice: ``N_rand * valid_ratio`` valid pixels, the rest
    invalid ones inside the window, none repeated while the window has
    enough; with valid pixels in the majority a uniform draw."""
    H = W = 16
    mask = torch.zeros(H, W, 1)
    mask[4:8, 4:8] = 1.0                      # 16 valid pixels of 256
    ys, xs = ttrainer.select_pixels(H, W, 40, False, 4, 4, {}, torch.Generator().manual_seed(0),
                                    'cpu', 0.5, mask)
    picked = mask[ys, xs, 0]
    assert int(picked.sum()) == 16            # min(20, 16) valid pixels, then invalid ones
    assert len(set(zip(ys.tolist(), xs.tolist()))) == 40
    ys, xs = ttrainer.select_pixels(H, W, 40, True, 4, 4, {}, torch.Generator().manual_seed(0),
                                    'cpu', 0.5, torch.ones(H, W, 1))
    assert ys.min() >= 4 and ys.max() < 12 and xs.min() >= 4 and xs.max() < 12


@pytest.mark.parametrize('n', [0, 1, 7, 250, 123457])
def test_learning_rate_schedule_equals_optax(n):
    import optax
    sched = optax.exponential_decay(5e-4, 500 * 1000, 0.1)
    opt = ttrainer.NerfOptimizer([torch.zeros(1, requires_grad=True)], 5e-4, 500 * 1000)
    np.testing.assert_allclose(opt.lr(n), float(sched(n)), rtol=1e-7)


def test_accumulation_moves_once_per_two_micro_steps():
    p = torch.zeros(3, requires_grad=True)
    opt = ttrainer.NerfOptimizer([p], 1e-2, 1000, accumulation_steps=2)
    p.grad = torch.ones(3)
    assert not opt.step() and float(p.abs().max()) == 0.0 and opt.count == 0
    p.grad = torch.full((3,), 3.0)
    assert opt.step() and opt.count == 1
    np.testing.assert_allclose(p.detach().numpy(), -1e-2, rtol=1e-5)


# -- the trainer ------------------------------------------------------------------

BLENDER_CFG = """expname = {name}
dataset_type = blender
white_bkgd = True
{extra}
N_samples = 16
N_rand = 128
netdepth = 2
netwidth = 32
netdepth_fine = 2
netwidth_fine = 32
multires = 4
multires_views = 2
lrate = 0.005
N_iters = {iters}
steps_per_dispatch = {spd}
i_print = 10
i_weights = {weights}
testskip = 1
"""


def _train_args(tmp_path, name, extra='', iters=120, spd=10, weights=0, more=()):
    root = str(tmp_path / 'data')
    if not os.path.exists(root):
        make_blender_dataset(root)
    cfg = tmp_path / f'{name}.txt'
    cfg.write_text(BLENDER_CFG.format(name=name, extra=extra, iters=iters, spd=spd,
                                      weights=weights))
    return tconfig.parse_args(['--config', str(cfg), '--datadir', root,
                               '--basedir', str(tmp_path / 'logs'), *more])


def _rose(history, by):
    psnrs = [h[2] for h in history]
    assert np.isfinite(psnrs[-1]) and psnrs[-1] > psnrs[0] + by, f'PSNR did not rise: {psnrs}'


@pytest.mark.parametrize('case', ['no_batching', 'batched', 'mask_guided', 'accumulate',
                                  'accumulate_batched'])
def test_train_blender_rises(tmp_path, case):
    """The configurations of ``tests/test_nerf_train_e2e.py`` on the port."""
    extra = {'no_batching': 'no_batching = True\nN_importance = 8\nuse_viewdirs = True',
             'batched': '',
             'mask_guided': 'no_batching = True\nvalid_ratio = 0.8',
             'accumulate': 'no_batching = True\naccumulation_steps = 2',
             'accumulate_batched': 'accumulation_steps = 2'}[case]
    args = _train_args(tmp_path, case, extra)
    nets, opt, history = ttrainer.train(args, device='cpu')
    _rose(history, 2.0 if case in ('no_batching', 'batched') else 1.0)
    assert opt.count == 120 // args.accumulation_steps


def test_train_llff_ndc_batched_rises(tmp_path):
    root = str(tmp_path / 'scene')
    make_llff_dataset(root)
    cfg = tmp_path / 'cfg.txt'
    cfg.write_text("""expname = tl
dataset_type = llff
factor = 1
llffhold = 8
N_samples = 16
N_rand = 128
netdepth = 2
netwidth = 32
multires = 4
lrate = 0.005
N_iters = 100
steps_per_dispatch = 10
i_print = 10
i_weights = 0
""")
    args = tconfig.parse_args(['--config', str(cfg), '--datadir', root,
                               '--basedir', str(tmp_path / 'logs')])
    assert not args.no_batching and not args.no_ndc
    _, _, history = ttrainer.train(args, device='cpu')
    _rose(history, 1.0)


@pytest.mark.parametrize('case', ['no_batching', 'accumulate_batched'])
def test_resume_equals_straight_run(tmp_path, case):
    """40 steps straight, against 20 (a checkpoint) then a resume to 40; the
    accumulating case saves mid-cycle (25 micro-steps) to carry the
    accumulated gradients."""
    extra, spd, stop = (('no_batching = True\nN_importance = 8\nuse_viewdirs = True', 10, 20)
                        if case == 'no_batching' else ('accumulation_steps = 2', 5, 25))
    straight = _train_args(tmp_path / 'a', 'r', extra, iters=2 * stop, spd=spd, weights=stop)
    nets_a, opt_a, _ = ttrainer.train(straight, device='cpu')
    first = _train_args(tmp_path / 'b', 'r', extra, iters=stop, spd=spd, weights=stop)
    ttrainer.train(first, device='cpu')
    ckpts = os.listdir(tmp_path / 'b' / 'logs' / 'r' / 'ckpts')
    assert ckpts == [f'{stop:09d}.tar']
    resumed = _train_args(tmp_path / 'b', 'r', extra, iters=2 * stop, spd=spd, weights=stop)
    nets_b, opt_b, _ = ttrainer.train(resumed, device='cpu')
    for a, b in zip(leaves(convert.nerf_params_to_numpy(nets_a)),
                    leaves(convert.nerf_params_to_numpy(nets_b))):
        np.testing.assert_array_equal(a, b)
    assert opt_a.count == opt_b.count
    for sa, sb in zip(opt_a.adam.state.values(), opt_b.adam.state.values()):
        for k in ('exp_avg', 'exp_avg_sq'):
            np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy())


def test_profile_dir_val_png_video_and_testset(tmp_path):
    """--profile_dir writes a trace of the second dispatch; i_img writes the
    validation PNG; i_video and i_testset their renders."""
    prof = str(tmp_path / 'prof')
    args = _train_args(tmp_path, 'tp', 'no_batching = True\ni_img = 20\ni_video = 20\n'
                       'i_testset = 20', iters=20, spd=10, more=('--profile_dir', prof))
    _, _, history = ttrainer.train(args, device='cpu')
    assert np.isfinite(history[-1][2])
    traces = [f for _, _, fs in os.walk(prof) for f in fs]
    assert traces and traces[0].endswith('.json')
    with open(os.path.join(prof, traces[0])) as f:
        assert json.load(f)['traceEvents']
    exp = tmp_path / 'logs' / 'tp'
    pngs = list((exp / 'val_imgs').glob('*.png'))
    assert pngs and image_io.read_raw(pngs[0]).shape == (24, 24, 3)
    assert list(exp.glob('*rgb.mp4')) + list(exp.glob('*rgb.gif'))
    assert list(next(exp.glob('testset_*')).glob('*.png'))


def test_main_entry_point(tmp_path, capsys):
    from jrender_tpu_torch.nerf.__main__ import main
    args = _train_args(tmp_path, 'tm', 'no_batching = True', iters=10, spd=10)
    assert main(['--config', args.config, '--datadir', args.datadir, '--basedir',
                 args.basedir, '--device', 'cpu']) == 0
    assert '[TRAIN] Iter: 10' in capsys.readouterr().out


def test_train_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: train(args) runs on it')
    args = _train_args(tmp_path, 'td', 'no_batching = True', iters=10, spd=10)
    with pytest.raises(RuntimeError, match='CUDA'):
        ttrainer.train(args)


# -- profiling --------------------------------------------------------------------

def test_annotate_timed_and_trace(tmp_path):
    d = str(tmp_path / 'trace')
    with profiling.trace(d):
        with profiling.annotate('outer'):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    files = os.listdir(d)
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'outer' in names


def test_trace_raises_what_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / 't')):
            raise ValueError('not swallowed')
