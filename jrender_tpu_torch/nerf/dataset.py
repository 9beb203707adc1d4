"""NeRF dataset loaders (host-side numpy; the port's own copy).

The loaders of ``jrender_tpu/nerf/dataset.py``, line for line, reading
and writing images through the port's ``io/image`` (imageio, else PIL,
else the port's PNG codec):
  * Blender   -- nerf_helper/load_blender.py:28-123
  * LLFF      -- nerf_helper/load_llff.py:8-319 (minify resizes with PIL's
                 box filter instead of shelling out to mogrify)
  * DeepVoxels-- nerf_helper/load_deepvoxels.py:6-110
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..io.image import imwrite, read_raw


def _imread(path):
    return read_raw(path)


def _resize_area(img, W, H):
    """Area-averaging resize (cv2.INTER_AREA equivalent) via PIL."""
    from PIL import Image
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        # resize each channel in float via PIL 'F' mode
        chans = []
        for c in range(arr.shape[-1]):
            im = Image.fromarray(arr[..., c].astype(np.float32), mode='F')
            chans.append(np.asarray(im.resize((W, H), Image.BOX)))
        return np.stack(chans, -1)
    im = Image.fromarray(arr)
    return np.asarray(im.resize((W, H), Image.BOX))


# -- Blender ----------------------------------------------------------------

def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]],
                    np.float32)


def _rot_phi(phi):
    return np.array([[1, 0, 0, 0],
                     [0, np.cos(phi), -np.sin(phi), 0],
                     [0, np.sin(phi), np.cos(phi), 0],
                     [0, 0, 0, 1]], np.float32)


def _rot_theta(th):
    return np.array([[np.cos(th), 0, -np.sin(th), 0],
                     [0, 1, 0, 0],
                     [np.sin(th), 0, np.cos(th), 0],
                     [0, 0, 0, 1]], np.float32)


def pose_spherical(theta, phi, radius):
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                   np.float32) @ c2w
    return c2w


def normalize_pose(all_poses, target_radius):
    cam_position = all_poses[..., :3, 3]
    avg = np.mean(cam_position, axis=0, keepdims=True)
    max_dist = np.max(np.linalg.norm(cam_position - avg, axis=1, keepdims=True))
    all_poses[..., :3, 3] = (cam_position - avg) * (target_radius / max_dist)
    return all_poses


def load_blender_data(basedir, half_res=False, testskip=1, factor=1,
                      do_pose_normalization=False, target_radius=1.0,
                      do_intrinsic=False):
    if half_res and factor == 1:
        factor = 2
    splits = ['train', 'val', 'test']
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f'transforms_{s}.json')) as fp:
            metas[s] = json.load(fp)

    all_imgs = []
    all_poses = []
    counts = [0]
    for s in splits:
        meta = metas[s]
        imgs = []
        poses = []
        skip = 1 if (s == 'train' or testskip == 0) else testskip
        for frame in meta['frames'][::skip]:
            if s != 'test':
                imgs.append(_imread(os.path.join(basedir, frame['file_path'] + '.png')))
            poses.append(np.array(frame['transform_matrix']))
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + poses.shape[0])
        all_poses.append(poses)
        if s != 'test':
            all_imgs.append((np.array(imgs) / 255.0).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    if do_pose_normalization:
        poses = normalize_pose(poses, target_radius)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta['camera_angle_x'])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    intrinsic = None
    if do_intrinsic:
        a = np.array(meta['intrinsic_matrix'])
        if factor > 1:
            a[:2] /= float(factor)
        intrinsic = np.linalg.inv(a)

    render_poses = np.stack([pose_spherical(angle, -30.0, 4.0)
                             for angle in np.linspace(-180, 180, 41)[:-1]], 0)

    if factor > 1:
        H = H // factor
        W = W // factor
        focal = focal / float(factor)
        imgs = np.stack([_resize_area(img, W, H) for img in imgs], 0)

    if do_intrinsic:
        return imgs, poses, intrinsic, render_poses, [H, W, focal], i_split
    return imgs, poses, render_poses, [H, W, focal], i_split


# -- LLFF -------------------------------------------------------------------

# LLFF pose conventions (c2w columns = [right(x), up(y), forward(z),
# origin], trailing 5th column = [H, W, focal]) follow the public LLFF
# data-loading recipe that the reference also builds on
# (nerf_helper/load_llff.py); the code below is a vectorized
# homogeneous-matrix formulation of that recipe.

def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _look_frames(forward, up_hint, origin):
    """Orthonormal c2w frames from forward axes + an up hint.

    All arguments broadcast over a leading batch dim; returns [..., 3, 4]
    with columns [right, true_up, forward, origin]."""
    fwd = _unit(forward)
    right = _unit(np.cross(up_hint, fwd))
    true_up = _unit(np.cross(fwd, right))
    return np.stack([right, true_up, fwd, origin], axis=-1)


def _to_h(p34):
    """[..., 3, 4] -> homogeneous [..., 4, 4]."""
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]),
                             p34.shape[:-2] + (1, 4))
    return np.concatenate([p34, bottom], axis=-2)


def _mean_pose(poses):
    """Average camera: mean origin, summed forward/up axes.  poses is
    [N, 3, 5] (pose | hwf); returns the same [3, 5] layout."""
    frame = _look_frames(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0),
                         poses[:, :3, 3].mean(0))
    return np.concatenate([frame, poses[0, :3, -1:]], axis=1)


def _render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """Camera path spiraling about the average pose, looking through a
    fixed focus point on its optical axis.  Vectorized over the path."""
    theta = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    offsets = np.stack([np.cos(theta), -np.sin(theta),
                        -np.sin(theta * zrate), np.ones_like(theta)], -1)
    offsets = offsets * np.array(list(rads) + [1.0])
    origins = offsets @ c2w[:3, :4].T                       # [N, 3]
    focus = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    frames = _look_frames(origins - focus, np.broadcast_to(up, origins.shape),
                          origins)
    hwf = np.broadcast_to(c2w[:, 4:5], frames.shape[:1] + (3, 1))
    return list(np.concatenate([frames, hwf], axis=-1))


def _recenter_poses(poses):
    """Re-express every pose in the average camera's frame."""
    world_from_avg = _to_h(_mean_pose(poses)[:3, :4])
    rebased = np.linalg.inv(world_from_avg) @ _to_h(poses[:, :3, :4])
    out = poses.copy()
    out[:, :3, :4] = rebased[:, :3, :4]
    return out


def _spherify_poses(poses, bds):
    """Normalize an inward-facing capture onto the unit sphere and make a
    circular render path at the cameras' mean height."""
    # Least-squares point nearest all optical axes: for each camera with
    # origin o and forward d, project out d (P = I - d d^T) and solve
    # mean(P^T P) x = mean(P^T P o).
    fwd = poses[:, :3, 2:3]
    origin = poses[:, :3, 3:4]
    P = np.eye(3) - fwd * np.transpose(fwd, (0, 2, 1))
    center = np.squeeze(np.linalg.inv((np.transpose(P, (0, 2, 1)) @ P).mean(0))
                        @ (P @ origin).mean(0))

    # World frame whose z points along the capture's mean up direction
    # (the [.1,.2,.3] cross partner is the LLFF-canonical tie-break).
    zaxis = _unit((poses[:, :3, 3] - center).mean(0))
    xaxis = _unit(np.cross([0.1, 0.2, 0.3], zaxis))
    yaxis = _unit(np.cross(zaxis, xaxis))
    frame = np.stack([xaxis, yaxis, zaxis, center], axis=1)

    rebased = np.linalg.inv(_to_h(frame[None])) @ _to_h(poses[:, :3, :4])
    rebased = rebased[:, :3, :4].copy()
    radius = np.sqrt(np.mean(np.sum(rebased[:, :3, 3] ** 2, -1)))
    rebased[:, :3, 3] /= radius
    bds = bds / radius

    # Circular path: ring of radius sqrt(1 - h^2) at the mean camera
    # height h, cameras facing radially outward.  LLFF builds this frame
    # as right = cross(fwd, -z); with _look_frames' right = cross(hint,
    # fwd) convention that is the +z hint.
    height = np.mean(rebased[:, :3, 3], 0)[2]
    ring_r = np.sqrt(1.0 - height ** 2)
    th = np.linspace(0.0, 2.0 * np.pi, 120)
    ring = np.stack([ring_r * np.cos(th), ring_r * np.sin(th),
                     np.full_like(th, height)], -1)
    path = _look_frames(ring, np.array([0.0, 0.0, 1.0]), ring)

    hwf = poses[0, :3, -1:]
    path = np.concatenate(
        [path, np.broadcast_to(hwf, path.shape[:1] + (3, 1))], -1)
    rebased = np.concatenate(
        [rebased, np.broadcast_to(hwf, rebased.shape[:1] + (3, 1))], -1)
    return rebased, path, bds


def _poses_avg(poses):  # retained name used by load_llff_data below
    return _mean_pose(poses)


def _minify(basedir, factors=(), resolutions=()):
    """Generate downsampled image dirs with PIL (no mogrify dependency)."""
    need = False
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f'images_{r}')):
            need = True
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir, 'images_{}x{}'.format(r[1], r[0]))):
            need = True
    if not need:
        return

    imgdir = os.path.join(basedir, 'images')
    imgs = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
            if f.lower().endswith(('jpg', 'jpeg', 'png'))]
    for r in list(factors) + list(resolutions):
        if isinstance(r, int):
            name = f'images_{r}'
        else:
            name = 'images_{}x{}'.format(r[1], r[0])
        outdir = os.path.join(basedir, name)
        if os.path.exists(outdir):
            continue
        os.makedirs(outdir)
        for f in imgs:
            img = _imread(f)
            H0, W0 = img.shape[:2]
            if isinstance(r, int):
                W, H = W0 // r, H0 // r
            else:
                H, W = r
            out = _resize_area(img, W, H)
            base = os.path.splitext(os.path.basename(f))[0] + '.png'
            imwrite(os.path.join(outdir, base), np.clip(out, 0, 255).astype(np.uint8))


def _load_llff_raw(basedir, factor=None, width=None, height=None, load_imgs=True):
    poses_arr = np.load(os.path.join(basedir, 'poses_bounds.npy'))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    img0 = [os.path.join(basedir, 'images', f)
            for f in sorted(os.listdir(os.path.join(basedir, 'images')))
            if f.lower().endswith(('jpg', 'png'))][0]
    sh = _imread(img0).shape

    sfx = ''
    if factor is not None:
        sfx = f'_{factor}'
        _minify(basedir, factors=[factor])
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f'_{width}x{height}'
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f'_{width}x{height}'
    else:
        factor = 1

    imgdir = os.path.join(basedir, 'images' + sfx)
    imgfiles = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
                if f.lower().endswith(('jpg', 'png'))]
    sh = _imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    if not load_imgs:
        return poses, bds
    imgs = [(_imread(f)[..., :3] / 255.0) for f in imgfiles]
    imgs = np.stack(imgs, -1)
    return poses, bds, imgs


def load_llff_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False, path_zflat=False):
    poses, bds, imgs = _load_llff_raw(basedir, factor=factor)

    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    images = imgs
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _unit(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views = 120
        N_rots = 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = _render_path_spiral(c2w_path, up, rads, focal, zdelta,
                                           zrate=0.5, rots=N_rots, N=N_views)

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images.astype(np.float32), poses.astype(np.float32), bds, \
        render_poses, i_test


# -- DeepVoxels -------------------------------------------------------------

def load_dv_data(scene='cube', basedir='/data/deepvoxels', testskip=8):
    def parse_intrinsics(filepath, trgt_sidelength, invert_y=False):
        with open(filepath) as file:
            f, cx, cy = list(map(float, file.readline().split()))[:3]
            grid_barycenter = np.array(list(map(float, file.readline().split())))
            near_plane = float(file.readline())
            scale = float(file.readline())
            height, width = map(float, file.readline().split())
            try:
                world2cam_poses = int(file.readline())
            except ValueError:
                world2cam_poses = None
        world2cam_poses = bool(world2cam_poses) if world2cam_poses is not None else False
        cx = cx / width * trgt_sidelength
        cy = cy / height * trgt_sidelength
        f = trgt_sidelength / height * f
        fy = -f if invert_y else f
        full_intrinsic = np.array([[f, 0.0, cx, 0.0], [0.0, fy, cy, 0],
                                   [0.0, 0, 1, 0], [0, 0, 0, 1]])
        return full_intrinsic, grid_barycenter, scale, near_plane, world2cam_poses

    def load_pose(filename):
        nums = open(filename).read().split()
        return np.array([float(x) for x in nums]).reshape([4, 4]).astype(np.float32)

    H = W = 512
    base = f'{basedir}/train/{scene}/'
    full_intrinsic, *_ = parse_intrinsics(os.path.join(base, 'intrinsics.txt'), H)
    focal = full_intrinsic[0, 0]

    def dir2poses(posedir):
        poses = np.stack([load_pose(os.path.join(posedir, f))
                          for f in sorted(os.listdir(posedir)) if f.endswith('txt')], 0)
        transf = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
        return (poses @ transf)[:, :3, :4].astype(np.float32)

    poses = dir2poses(os.path.join(base, 'pose'))
    testposes = dir2poses(f'{basedir}/test/{scene}/pose')[::testskip]
    valposes = dir2poses(f'{basedir}/validation/{scene}/pose')[::testskip]

    def load_rgb_dir(d, skip=1):
        files = [f for f in sorted(os.listdir(d)) if f.endswith('png')][::skip]
        return np.stack([_imread(os.path.join(d, f)) / 255.0 for f in files], 0).astype(np.float32)

    imgs = load_rgb_dir(os.path.join(base, 'rgb'))
    testimgs = load_rgb_dir(f'{basedir}/test/{scene}/rgb', testskip)
    valimgs = load_rgb_dir(f'{basedir}/validation/{scene}/rgb', testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    render_poses = testposes
    return imgs, poses, render_poses, [H, W, focal], i_split
