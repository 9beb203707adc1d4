"""The NeRF trainer in plain PyTorch (counterpart of ``jrender_tpu/nerf/trainer.py``).

What it keeps from the JAX package (demo7-nerf.py's trainer):
  * ``create_nerf``: embedders, coarse and fine MLPs, Adam with the
    exponential decay of the learning rate, gradient accumulation, and
    checkpoint discovery and restore;
  * the step: rays drawn from one image (precrop window, mask-guided
    sampling) or from the shuffled pool of all training rays, the
    hierarchical render, MSE plus the coarse pass's MSE, one update;
  * the loop's cadence: ``steps_per_dispatch`` steps between two reads of
    the loss, and the print, checkpoint, validation, video and test-set
    renders at the JAX package's steps, the pool reshuffled by epochs.

What differs:
  * The JAX package fuses ``steps_per_dispatch`` steps into one
    ``lax.scan``; here they are a Python loop (no compilation), and the
    loss is read once a dispatch.
  * Draws.  Every step takes its draws as arguments (``draws``: the pixel
    choice ``hy``, ``hx``, ``fy``, ``fx`` or ``gumbel``, and the render's
    ``t_rand``, ``noise``, ``u``, ``noise2``, see ``vol.ray_marching``),
    else from ``generator``.  ``train`` seeds a generator per dispatch from
    (``seed``, step) and each pool permutation from (``seed``, its number),
    so a run resumed from a checkpoint draws what the straight run drew.
  * Checkpoints are ``torch.save`` files of ``{step, params, optimizer}``
    (Adam's moments, the schedule's count and the accumulated gradients).
  * ``train(args, device=None)`` runs on the card, or where ``device``
    says; it returns ``(nets, optimizer, history)``.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..io import image as image_io
from ..vol import render_pass
from ..vol.camera import pinhole_get_rays
from . import dataset
from .model import NeRF, get_embedder, img2mse, mse2psnr, nerf_apply, to8b

RENDER_DRAWS = ('t_rand', 'noise', 'u', 'noise2')


def make_network_query_fn(embed_fn, embeddirs_fn, input_ch, input_ch_views, skips,
                          use_viewdirs, netchunk=1024 * 64, compute_dtype=None):
    """Embeds points (and directions) and evaluates the MLP (a ``NeRF`` or a
    weight tree) on chunks of ``netchunk`` points."""

    def query(pts, viewdirs, net):
        params = net.tree() if isinstance(net, NeRF) else net
        sh = pts.shape
        flat = pts.reshape(-1, sh[-1])
        embedded = embed_fn(flat)
        if viewdirs is not None:
            dirs = viewdirs[:, None, :].expand(*sh[:-1], viewdirs.shape[-1])
            embedded = torch.cat([embedded, embeddirs_fn(dirs.reshape(-1, dirs.shape[-1]))], -1)
        N = embedded.shape[0]
        outs = [nerf_apply(params, embedded[i:i + netchunk], input_ch, input_ch_views, skips,
                           use_viewdirs, compute_dtype=compute_dtype)
                for i in range(0, N, netchunk)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        return out.reshape(sh[:-1] + (out.shape[-1],))

    return query


class NerfOptimizer:
    """Adam (``betas=(0.9, 0.999)``, ``eps=1e-7``) with the JAX package's
    exponential decay: before update n (counted from 0) the rate is
    ``lrate * 0.1 ** (n / decay_steps)``, in float32 as the JAX package
    computes it.  With ``accumulation_steps`` = k > 1 it averages the
    gradients of k micro-steps (a running mean, as the JAX package's
    accumulation does) and updates on the k-th; n counts updates only."""

    def __init__(self, params, lrate, decay_steps, accumulation_steps=1):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lrate, betas=(0.9, 0.999), eps=1e-7)
        self.lrate = lrate
        self.decay_steps = decay_steps
        self.acc = max(1, int(accumulation_steps))
        self.count = 0
        self.mini_step = 0
        self.acc_grads = None

    def lr(self, n=None) -> float:
        n = self.count if n is None else n
        p = np.float32(n) / np.float32(self.decay_steps)
        return float(np.float32(self.lrate) * np.power(np.float32(0.1), p))

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply the parameters' ``.grad``; True where the parameters moved."""
        if self.acc > 1:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            self.acc_grads = [a + (g - a) / (n + 1) for g, a in zip(grads, self.acc_grads)]
            self.mini_step = (n + 1) % self.acc
            if self.mini_step != 0:
                return False
            for p, a in zip(self.params, self.acc_grads):
                p.grad = a
            self.acc_grads = None
        for group in self.adam.param_groups:
            group['lr'] = self.lr()
        self.adam.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {'adam': self.adam.state_dict(), 'count': self.count,
                'mini_step': self.mini_step,
                'acc_grads': None if self.acc_grads is None else [a.clone() for a in self.acc_grads]}

    def load_state_dict(self, state: dict):
        self.adam.load_state_dict(state['adam'])
        self.count = int(state['count'])
        self.mini_step = int(state['mini_step'])
        acc = state['acc_grads']
        self.acc_grads = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


def _compute_dtype(args):
    return torch.bfloat16 if getattr(args, 'net_precision', 'f32') == 'bf16' else None


def create_nerf(args, generator=None, device=None):
    """Embedders, the coarse (and fine) ``NeRF`` in an ``nn.ModuleDict``, the
    optimizer and the render kwargs; restores the newest checkpoint.

    Returns (render_kwargs_train, render_kwargs_test, start, nets,
    optimizer).  The weights are drawn on the CPU from ``generator`` (None:
    one seeded ``args.seed``), then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    input_dims = 4 if getattr(args, 'embed_depth', False) else 3
    embed_fn, input_ch = get_embedder(args.multires, args.i_embed, input_dims)
    input_ch_views = 0
    embeddirs_fn = None
    if args.use_viewdirs:
        embeddirs_fn, input_ch_views = get_embedder(args.multires_views, args.i_embed)
    output_ch = 5 if args.N_importance > 0 else 4
    skips = (4,)

    def net(D, W):
        return NeRF(D, W, input_ch, input_ch_views, output_ch, skips, args.use_viewdirs,
                    generator=generator)

    nets = nn.ModuleDict({'coarse': net(args.netdepth, args.netwidth)})
    if args.N_importance > 0:
        nets['fine'] = net(args.netdepth_fine, args.netwidth_fine)
    nets.to(device)

    network_query_fn = make_network_query_fn(embed_fn, embeddirs_fn, input_ch, input_ch_views,
                                             skips, args.use_viewdirs, args.netchunk,
                                             compute_dtype=_compute_dtype(args))
    render_kwargs_train = {
        'network_query_fn': network_query_fn,
        'perturb': args.perturb,
        'N_importance': args.N_importance,
        'N_samples': args.N_samples,
        'use_viewdirs': args.use_viewdirs,
        'white_bkgd': args.white_bkgd,
        'raw_noise_std': args.raw_noise_std,
        'embed_depth': getattr(args, 'embed_depth', False),
    }
    if args.dataset_type != 'llff' or args.no_ndc:
        render_kwargs_train['ndc'] = False
        render_kwargs_train['lindisp'] = args.lindisp
    render_kwargs_test = dict(render_kwargs_train)
    render_kwargs_test['perturb'] = 0.0
    render_kwargs_test['raw_noise_std'] = 0.0

    optimizer = NerfOptimizer(nets.parameters(), args.lrate, args.lrate_decay * 1000,
                              getattr(args, 'accumulation_steps', 1))

    start = 0
    ckpt_dir = os.path.join(args.basedir, args.expname, 'ckpts')
    if args.ft_path is not None and args.ft_path != 'None':
        ckpts = [args.ft_path]
    else:
        ckpts = sorted(os.path.join(ckpt_dir, f) for f in
                       (os.listdir(ckpt_dir) if os.path.exists(ckpt_dir) else []))
    if len(ckpts) > 0 and not args.no_reload:
        print('Reloading from', ckpts[-1])
        start = restore_checkpoint(ckpts[-1], nets, optimizer)
    return render_kwargs_train, render_kwargs_test, start, nets, optimizer


def save_checkpoint(ckpt_dir, step, nets, optimizer):
    """Write step, weights and the optimizer's whole state (a resume keeps
    Adam's moments and the schedule's count)."""
    path = os.path.abspath(os.path.join(ckpt_dir, f'{step:09d}.tar'))
    torch.save({'step': step, 'params': nets.state_dict(),
                'optimizer': optimizer.state_dict()}, path)
    return path


def restore_checkpoint(path, nets, optimizer):
    """Load a checkpoint into ``nets`` and ``optimizer``; returns its step."""
    state = torch.load(path, map_location=_device_of(nets), weights_only=False)
    nets.load_state_dict(state['params'])
    optimizer.load_state_dict(state['optimizer'])
    return int(state['step'])


def _fine(nets):
    return nets['fine'] if 'fine' in nets else None


def _device_of(nets):
    return next(nets.parameters()).device


def render_full_image(H, W, focal, c2w, nets, render_kwargs, chunk=1024 * 32,
                      intrinsic=None, near=2.0, far=6.0, ndc=False):
    """Render one view without gradients; returns (rgb, disp, acc)."""
    kwargs = dict(render_kwargs)
    nq = kwargs.pop('network_query_fn')
    kwargs.pop('ndc', None)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=_device_of(nets))[:3, :4]
    with torch.no_grad():
        rgb, disp, acc, _ = render_pass.render(
            H, W, focal, chunk=chunk, c2w=c2w, intrinsic=intrinsic, ndc=ndc,
            network_fn=nets['coarse'], network_fine=_fine(nets), network_query_fn=nq,
            near=near, far=far, **kwargs)
    return rgb, disp, acc


def render_path(poses, hwf, nets, render_kwargs, chunk=1024 * 32,
                near=2.0, far=6.0, ndc=False, render_factor=0, savedir=None):
    """Render a pose path (spiral video, test set); returns uint8 frames."""
    H, W, focal = int(hwf[0]), int(hwf[1]), hwf[2]
    if render_factor > 0:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    rgbs = []
    for i, c2w in enumerate(poses):
        rgb, _, _ = render_full_image(H, W, focal, c2w, nets, render_kwargs, chunk,
                                      near=near, far=far, ndc=ndc)
        frame = to8b(rgb)
        rgbs.append(frame)
        if savedir is not None:
            image_io.imwrite(os.path.join(savedir, f'{i:03d}.png'), frame)
    return np.stack(rgbs, 0)


def _render_loss(nets, ro, rd, target, kwargs, network_query_fn, H, W, focal, near, far, ndc,
                 draws, generator):
    rdraws = {k: draws[k] for k in RENDER_DRAWS if k in draws}
    rgb, _, _, extras = render_pass.render(
        H, W, focal, chunk=ro.shape[0], rays=(ro, rd), ndc=ndc, near=near, far=far,
        draws=rdraws, generator=generator, network_fn=nets['coarse'],
        network_fine=_fine(nets), network_query_fn=network_query_fn, **kwargs)
    loss = img2mse(rgb, target)
    psnr = mse2psnr(loss.detach())
    if 'rgb0' in extras:
        loss = loss + img2mse(extras['rgb0'], target)
    return loss, psnr


def _update(optimizer, loss):
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()


def _draw(draws, key, make):
    v = draws.get(key)
    return make() if v is None else v


def gumbel(shape, generator=None, device=None):
    """Standard Gumbel draws, as ``jax.random.gumbel``: -log(-log(U)), U
    uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def select_pixels(H, W, N_rand, in_precrop, dH, dW, draws, generator, device,
                  valid_ratio=-1.0, mask=None):
    """The step's pixels (ys, xs): uniform over the image or the precrop
    window, or the mask-guided draw (demo7-nerf.py:526-563)."""
    if valid_ratio >= 0.0 and mask is not None:
        # three tiers: valid > invalid > outside the window; the Gumbel draws
        # order each tier at random, so a tier's prefix is a draw without
        # replacement.  Adding 2e4 leaves the draws about 0.002 apart, so
        # ties are common: the sorts are stable, as JAX's argsort is.
        yy, xx = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                                indexing='ij')
        if in_precrop:
            in_window = ((yy >= H // 2 - dH) & (yy < H // 2 + dH) &
                         (xx >= W // 2 - dW) & (xx < W // 2 + dW))
        else:
            in_window = torch.ones((H, W), dtype=torch.bool, device=device)
        valid = ((mask[..., 0] > 0.0) & in_window).reshape(-1)
        invalid = ((mask[..., 0] == 0.0) & in_window).reshape(-1)
        n_valid = valid.sum()
        n_invalid = invalid.sum()
        uniform = n_valid > n_invalid        # the reference draws uniformly then
        sample_size = torch.clamp_max(n_valid, int(N_rand * valid_ratio))
        sample_size = torch.where(uniform, torch.zeros_like(sample_size), sample_size)
        g = _draw(draws, 'gumbel', lambda: gumbel((H * W,), generator, device))
        far_ = torch.tensor(-2e4, device=device)
        tier = torch.where(valid, torch.tensor(2e4, device=device),
                           torch.where(invalid, torch.tensor(0.0, device=device), far_))
        order = torch.argsort(-(g + tier), stable=True)
        j = torch.arange(N_rand, device=device)
        last = H * W - 1                     # a gather clamps its index, as JAX's does
        in_window_last = torch.clamp_min(n_valid + n_invalid - 1, 0)
        rest = order[torch.minimum(torch.maximum(n_valid + (j - sample_size),
                                                 torch.zeros_like(j)), in_window_last)]
        pick = torch.where(j < sample_size, order[j.clamp_max(last)], rest)
        u_flat = torch.argsort(-(g + torch.where(in_window.reshape(-1),
                                                 torch.tensor(0.0, device=device), far_)),
                               stable=True)
        pick = torch.where(uniform, u_flat[j.clamp_max(last)], pick)
        return pick // W, pick % W
    if in_precrop:
        hy = _draw(draws, 'hy', lambda: torch.randint(0, 2 * dH, (N_rand,), generator=generator,
                                                      device=device))
        hx = _draw(draws, 'hx', lambda: torch.randint(0, 2 * dW, (N_rand,), generator=generator,
                                                      device=device))
        return H // 2 - dH + hy, W // 2 - dW + hx
    fy = _draw(draws, 'fy', lambda: torch.randint(0, H, (N_rand,), generator=generator,
                                                  device=device))
    fx = _draw(draws, 'fx', lambda: torch.randint(0, W, (N_rand,), generator=generator,
                                                  device=device))
    return fy, fx


def make_train_step(optimizer, render_kwargs, H, W, focal, near, far,
                    N_rand, precrop_iters, precrop_frac, ndc, valid_ratio=-1.0):
    """One step on rays drawn from one image: render, loss, update.

    ``step_fn(nets, image, pose, step, draws=None, generator=None,
    mask=None)`` returns the (loss, psnr) tensors, detached."""
    kwargs = dict(render_kwargs)
    network_query_fn = kwargs.pop('network_query_fn')
    dH = int(H // 2 * precrop_frac)
    dW = int(W // 2 * precrop_frac)

    def step_fn(nets, image, pose, step, draws=None, generator=None, mask=None):
        draws = draws or {}
        dev = image.device
        rays_o, rays_d = pinhole_get_rays(H, W, focal, pose)
        ys, xs = select_pixels(H, W, N_rand, step < precrop_iters, dH, dW, draws, generator,
                               dev, valid_ratio, mask)
        ys, xs = ys.to(dev), xs.to(dev)
        loss, psnr = _render_loss(nets, rays_o[ys, xs], rays_d[ys, xs], image[ys, xs], kwargs,
                                  network_query_fn, H, W, focal, near, far, ndc, draws,
                                  generator)
        _update(optimizer, loss)
        return loss.detach(), psnr

    return step_fn


def build_ray_pool(images, poses, i_train, H, W, focal):
    """The pool of every training ray, [N_train·H·W, 3, 3] rows of (ray_o,
    ray_d, rgb), in numpy (demo7-nerf.py:459-478)."""
    pools = []
    for i in np.asarray(i_train):
        ro, rd = pinhole_get_rays(H, W, focal, torch.as_tensor(np.asarray(poses[i][:3, :4]),
                                                               dtype=torch.float32))
        pools.append(np.stack([ro.numpy(), rd.numpy(), np.asarray(images[i][..., :3])], 2))
    pool = np.concatenate([p.reshape(-1, 3, 3) for p in pools], 0)
    return pool.astype(np.float32)


def make_batched_train_step(optimizer, render_kwargs, H, W, focal, near, far, N_rand, ndc):
    """One step on ``N_rand`` rays of the pool, ``perm[offset:offset +
    N_rand]`` (demo7-nerf.py:509-520; the offset is clamped so the slice
    fits, as ``lax.dynamic_slice`` clamps it).

    ``step_fn(nets, pool, perm, offset, draws=None, generator=None)``
    returns the (loss, psnr) tensors, detached."""
    kwargs = dict(render_kwargs)
    network_query_fn = kwargs.pop('network_query_fn')

    def step_fn(nets, pool, perm, offset, draws=None, generator=None):
        offset = max(0, min(int(offset), perm.shape[0] - N_rand))
        batch = pool[perm[offset:offset + N_rand]]
        ro, rd, target = batch[:, 0], batch[:, 1], batch[:, 2]
        loss, psnr = _render_loss(nets, ro, rd, target, kwargs, network_query_fn, H, W, focal,
                                  near, far, ndc, draws or {}, generator)
        _update(optimizer, loss)
        return loss.detach(), psnr

    return step_fn


def _make_summary_writer(expdir):
    """Tensorboard scalars and images (demo7-nerf.py:490-501,630-633);
    None where no tensorboard backend imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        try:
            from tensorboardX import SummaryWriter
        except Exception:
            return None
    logdir = os.path.join(expdir, 'summaries')
    os.makedirs(logdir, exist_ok=True)
    return SummaryWriter(log_dir=logdir)


def _seed(*parts) -> int:
    """A generator seed from integers (the run's seed, a stream, a counter)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


def write_video(path_mp4, frames):
    """An MP4 through imageio where it has a backend, else a GIF (imageio,
    else PIL); returns the path written."""
    if image_io.library() == 'imageio':
        import imageio.v2 as imageio
        try:
            imageio.mimwrite(path_mp4, frames, fps=30, quality=8)
            return path_mp4
        except (ValueError, ImportError):
            path = path_mp4[:-4] + '.gif'
            imageio.mimwrite(path, list(frames), fps=30)
            return path
    from PIL import Image
    path = path_mp4[:-4] + '.gif'
    ims = [Image.fromarray(np.asarray(f)) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=33, loop=0)
    return path


def _load_data(args):
    """The dataset of ``args``: (images, poses, render_poses, hwf, i_train,
    i_val, i_test, near, far, ndc, masks)."""
    masks = None
    if args.dataset_type == 'blender':
        images, poses, render_poses, hwf, i_split = dataset.load_blender_data(
            args.datadir, args.half_res, args.testskip, factor=args.blender_factor,
            do_pose_normalization=getattr(args, 'do_pose_normalization', False),
            target_radius=getattr(args, 'target_radius', 1.0))
        i_train, i_val, i_test = i_split
        i_test = i_test[::max(1, getattr(args, 'faketestskip', 1))]
        near, far = 2.0, 6.0
        masks = images[..., -1:]  # alpha channel (demo7-nerf.py:381)
        if args.white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]
        ndc = False
    elif args.dataset_type == 'llff':
        images, poses, bds, render_poses, i_test = dataset.load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75, spherify=args.spherify)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if not isinstance(i_test, list):
            i_test = [i_test]
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[::args.llffhold]
        i_val = i_test
        i_train = np.array([i for i in np.arange(int(images.shape[0]))
                            if (i not in i_test and i not in i_val)])
        if args.no_ndc:
            near = float(np.min(bds) * 0.9)
            far = float(np.max(bds) * 1.0)
            ndc = False
        else:
            near, far = 0.0, 1.0
            ndc = True
    elif args.dataset_type == 'deepvoxels':
        images, poses, render_poses, hwf, i_split = dataset.load_dv_data(
            scene=args.shape, basedir=args.datadir, testskip=args.testskip)
        i_train, i_val, i_test = i_split
        hemi_R = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        near, far = hemi_R - 1.0, hemi_R + 1.0
        ndc = False
    else:
        raise ValueError(f'Unknown dataset type {args.dataset_type}')
    if args.near is not None:
        near = args.near
    if args.far is not None:
        far = args.far
    return images, poses, render_poses, hwf, i_train, i_val, i_test, near, far, ndc, masks


def train(args, device=None):
    """Full training entry point (demo7-nerf.py's train()); returns
    (nets, optimizer, history), history a list of (step, loss, psnr)."""
    device = resolve_device(device)
    (images, poses, render_poses, hwf, i_train, i_val, i_test, near, far, ndc,
     masks) = _load_data(args)
    H, W, focal = hwf
    H, W = int(H), int(W)

    render_kwargs_train, render_kwargs_test, start, nets, optimizer = create_nerf(
        args, device=device)
    render_kwargs_train.pop('ndc', None)
    render_kwargs_train.pop('lindisp', None)
    render_kwargs_test.pop('ndc', None)
    render_kwargs_train['lindisp'] = args.lindisp
    render_kwargs_test['lindisp'] = args.lindisp

    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, 'args.txt'), 'w') as f:
        for k in sorted(vars(args)):
            f.write(f'{k} = {getattr(args, k)}\n')
    if getattr(args, 'config', None) and os.path.isfile(args.config):
        with open(args.config) as src, open(os.path.join(expdir, 'config.txt'), 'w') as dst:
            dst.write(src.read())

    spd = args.steps_per_dispatch
    use_batching = not args.no_batching
    valid_ratio = getattr(args, 'valid_ratio', -1.0)
    # gradient accumulation: each micro-step carries N_rand/acc rays
    acc = max(1, int(getattr(args, 'accumulation_steps', 1)))
    n_rand = max(1, args.N_rand // acc)
    images_d = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    poses_d = torch.as_tensor(np.asarray(poses[:, :3, :4] if poses.shape[1] > 3 else poses),
                              dtype=torch.float32, device=device)
    masks_d = (torch.as_tensor(np.asarray(masks), dtype=torch.float32, device=device)
               if (masks is not None and valid_ratio >= 0) else None)

    if use_batching:
        pool_np = build_ray_pool(images, poses, i_train, H, W, focal)
        pool_size = pool_np.shape[0]
        pool_d = torch.as_tensor(pool_np, device=device)
        del pool_np
        step_fn = make_batched_train_step(optimizer, render_kwargs_train, H, W, focal, near, far,
                                          n_rand, ndc)
        # a permutation holds enough independent epochs that a dispatch never
        # runs off its end; each dispatch starts where the last ended, and a
        # new permutation starts when the next would not fit
        n_epochs_per_perm = (spd * n_rand) // pool_size + 2
        perm_len = n_epochs_per_perm * pool_size
        per_perm = perm_len // (spd * n_rand)
        perm_cache = {}

        def perm_for(number):
            if number not in perm_cache:
                perm_cache.clear()
                g = torch.Generator(device=device).manual_seed(_seed(args.seed, 2, number))
                perm_cache[number] = torch.cat([torch.randperm(pool_size, generator=g,
                                                               device=device)
                                                for _ in range(n_epochs_per_perm)])
            return perm_cache[number]
    else:
        step_fn = make_train_step(optimizer, render_kwargs_train, H, W, focal, near, far, n_rand,
                                  args.precrop_iters, args.precrop_frac, ndc,
                                  valid_ratio=valid_ratio)

    writer = _make_summary_writer(expdir)

    global_step = start
    last_t, last_step = time.time(), global_step
    history = []
    while global_step < args.N_iters:
        gen = torch.Generator(device=device).manual_seed(_seed(args.seed, 0, global_step))
        prof = contextlib.ExitStack()
        if getattr(args, 'profile_dir', '') and global_step == start + spd:
            from ..utils import profiling
            prof.enter_context(profiling.trace(args.profile_dir, device))
        losses, psnrs = [], []
        with prof:
            if use_batching:
                number, k = divmod(global_step // spd, per_perm)
                perm = perm_for(number)
                for i in range(spd):
                    loss, psnr = step_fn(nets, pool_d, perm, (k * spd + i) * n_rand,
                                         generator=gen)
                    losses.append(loss)
                    psnrs.append(psnr)
            else:
                rng = np.random.RandomState(_seed(args.seed, 1, global_step) % (1 << 32))
                img_idx = rng.choice(i_train, size=spd)
                for i in range(spd):
                    j = int(img_idx[i])
                    loss, psnr = step_fn(nets, images_d[j], poses_d[j], global_step + i,
                                         generator=gen,
                                         mask=None if masks_d is None else masks_d[j])
                    losses.append(loss)
                    psnrs.append(psnr)
        global_step += spd

        if global_step % max(args.i_print // spd * spd, spd) == 0 or \
                global_step >= args.N_iters:
            loss = float(losses[-1])
            psnr = float(psnrs[-1])
            now = time.time()
            rate = (global_step - last_step) / max(now - last_t, 1e-9)
            last_t, last_step = now, global_step
            print(f'[TRAIN] Iter: {global_step} Loss: {loss:.6f}  PSNR: {psnr:.3f} '
                  f'({rate:.1f} it/s)', flush=True)
            history.append((global_step, loss, psnr))
            if writer is not None:
                writer.add_scalar('train/loss', loss, global_step)
                writer.add_scalar('train/psnr', psnr, global_step)
                writer.add_scalar('train/it_per_s', rate, global_step)

        if args.i_weights > 0 and global_step % args.i_weights < spd:
            ckpt_dir = os.path.join(expdir, 'ckpts')
            os.makedirs(ckpt_dir, exist_ok=True)
            path = save_checkpoint(ckpt_dir, global_step, nets, optimizer)
            print('Saved checkpoints at', path)

        if args.i_img > 0 and global_step % args.i_img < spd and len(i_val) > 0:
            vi = int(i_val[0])
            rgb, _, _ = render_full_image(H, W, focal, poses_d[vi], nets, render_kwargs_test,
                                          args.chunk, near=near, far=far, ndc=ndc)
            val_psnr = float(mse2psnr(img2mse(rgb, images_d[vi])))
            print(f'[VAL] Iter: {global_step} PSNR: {val_psnr:.3f}', flush=True)
            val_dir = os.path.join(expdir, 'val_imgs')
            os.makedirs(val_dir, exist_ok=True)
            image_io.imwrite(os.path.join(val_dir, f'{global_step:06d}.png'), to8b(rgb))
            if writer is not None:
                writer.add_scalar('test/psnr', val_psnr, global_step)
                writer.add_image('test/rgb', to8b(rgb), global_step, dataformats='HWC')
                writer.add_image('test/target', to8b(images_d[vi]), global_step,
                                 dataformats='HWC')

        if args.i_video > 0 and global_step % args.i_video < spd and \
                global_step >= args.i_video:
            rgbs = render_path(np.asarray(render_poses)[:, :3, :4], (H, W, focal), nets,
                               render_kwargs_test, args.chunk, near=near, far=far, ndc=ndc,
                               render_factor=max(args.render_factor, 1) * 2)
            path = write_video(os.path.join(
                expdir, f'{args.expname}_spiral_{global_step:06d}_rgb.mp4'), rgbs)
            print('Saved video', path)

        if args.i_testset > 0 and global_step % args.i_testset < spd and \
                global_step >= args.i_testset and len(i_test) > 0:
            testsavedir = os.path.join(expdir, f'testset_{global_step:06d}')
            os.makedirs(testsavedir, exist_ok=True)
            render_path(poses_d[torch.as_tensor(np.asarray(i_test), device=device)],
                        (H, W, focal), nets, render_kwargs_test, args.chunk, near=near,
                        far=far, ndc=ndc, savedir=testsavedir,
                        render_factor=max(args.render_factor, 1) * 2)
            print('Saved test set renders to', testsavedir)

    if writer is not None:
        writer.flush()
        writer.close()
    return nets, optimizer, history
