"""Config and flags of the NeRF trainer (the port's own copy).

The same flags and defaults as ``jrender_tpu/nerf/config.py``, and the same
``key = value`` files (``configs/*.txt``; booleans as ``key = True``), on
plain argparse: the two packages parse a file to equal namespaces.
"""
from __future__ import annotations

import argparse


def _apply_config_file(parser, args, argv):
    if args.config:
        overrides = {}
        with open(args.config) as f:
            for line in f:
                line = line.split('#')[0].strip()
                if not line or '=' not in line:
                    continue
                k, v = [x.strip() for x in line.split('=', 1)]
                overrides[k] = v
        # command line wins over config file; config wins over defaults
        explicit = set()
        for tok in argv:
            if tok.startswith('--'):
                explicit.add(tok.lstrip('-').split('=')[0])
        for k, v in overrides.items():
            if k in explicit or not hasattr(args, k):
                continue
            default = parser.get_default(k)
            if isinstance(default, bool) or v in ('True', 'False'):
                setattr(args, k, v == 'True')
            elif isinstance(default, int):
                setattr(args, k, int(v))
            elif isinstance(default, float):
                setattr(args, k, float(v))
            else:
                setattr(args, k, v)
    return args


def config_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, default=None, help='config file path')
    parser.add_argument('--expname', type=str, default='exp', help='experiment name')
    parser.add_argument('--basedir', type=str, default='./logs/', help='where to store ckpts and logs')
    parser.add_argument('--datadir', type=str, default='./data/nerf/lego', help='input data directory')

    # training options
    parser.add_argument('--netdepth', type=int, default=8)
    parser.add_argument('--netwidth', type=int, default=256)
    parser.add_argument('--netdepth_fine', type=int, default=8)
    parser.add_argument('--netwidth_fine', type=int, default=256)
    parser.add_argument('--N_rand', type=int, default=32 * 32 * 4)
    parser.add_argument('--lrate', type=float, default=5e-4)
    parser.add_argument('--lrate_decay', type=int, default=250)
    parser.add_argument('--chunk', type=int, default=1024 * 32)
    parser.add_argument('--netchunk', type=int, default=1024 * 64)
    parser.add_argument('--net_precision', type=str, default='f32',
                        choices=['f32', 'bf16'],
                        help='MLP matmul operands; bf16 keeps f32 params '
                             'and rounds both operands of every product to '
                             'bfloat16, summing in float32')
    parser.add_argument('--no_batching', action='store_true')
    parser.add_argument('--no_reload', action='store_true')
    parser.add_argument('--ft_path', type=str, default=None)
    parser.add_argument('--N_iters', type=int, default=50000)
    parser.add_argument('--accumulation_steps', type=int, default=1)

    # rendering options
    parser.add_argument('--N_samples', type=int, default=64)
    parser.add_argument('--N_importance', type=int, default=0)
    parser.add_argument('--perturb', type=float, default=1.0)
    parser.add_argument('--use_viewdirs', action='store_true')
    parser.add_argument('--i_embed', type=int, default=0)
    parser.add_argument('--multires', type=int, default=10)
    parser.add_argument('--multires_views', type=int, default=4)
    parser.add_argument('--raw_noise_std', type=float, default=0.0)
    parser.add_argument('--render_only', action='store_true')
    parser.add_argument('--render_test', action='store_true')
    parser.add_argument('--render_factor', type=int, default=0)

    # precrop
    parser.add_argument('--precrop_iters', type=int, default=0)
    parser.add_argument('--precrop_frac', type=float, default=0.5)
    parser.add_argument('--valid_ratio', type=float, default=-1.0,
                        help='mask-guided sampling: fraction of rays drawn '
                             'from valid (mask>0) pixels; <0 disables '
                             '(demo7-nerf.py:263,545-563)')

    # dataset options
    parser.add_argument('--dataset_type', type=str, default='llff')
    parser.add_argument('--testskip', type=int, default=8)
    parser.add_argument('--shape', type=str, default='greek')
    parser.add_argument('--white_bkgd', action='store_true')
    parser.add_argument('--half_res', action='store_true')
    parser.add_argument('--factor', type=int, default=8)
    parser.add_argument('--no_ndc', action='store_true')
    parser.add_argument('--lindisp', action='store_true')
    parser.add_argument('--spherify', action='store_true')
    parser.add_argument('--llffhold', type=int, default=8)
    parser.add_argument('--near', type=float, default=None)
    parser.add_argument('--far', type=float, default=None)
    parser.add_argument('--do_intrinsic', action='store_true')
    parser.add_argument('--blender_factor', type=int, default=1)
    parser.add_argument('--faketestskip', type=int, default=1,
                        help='further subsample the test split for periodic '
                             'eval (demo7-nerf.py:261,369)')
    parser.add_argument('--do_pose_normalization', action='store_true',
                        help='recenter+rescale blender camera positions onto '
                             'a target_radius sphere (load_blender.py:111)')
    parser.add_argument('--target_radius', type=float, default=1.0)
    parser.add_argument('--embed_depth', action='store_true',
                        help='append the sample depth as a 4th positionally '
                             'embedded coordinate (demo7-nerf.py:98,204; '
                             'rayMarching.py:57)')

    # logging/saving options
    parser.add_argument('--i_print', type=int, default=100)
    parser.add_argument('--i_img', type=int, default=500)
    parser.add_argument('--i_weights', type=int, default=10000)
    parser.add_argument('--i_testset', type=int, default=50000)
    parser.add_argument('--i_video', type=int, default=50000)
    parser.add_argument('--i_tottest', type=int, default=400000)

    # loop options
    parser.add_argument('--steps_per_dispatch', type=int, default=20,
                        help='train steps between two reads of the loss '
                             '(the print, checkpoint and validation cadence)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--profile_dir', type=str, default='',
                        help='write a torch.profiler trace of the second '
                             'dispatch of steps into this dir')
    return parser


def parse_args(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    parser = config_parser()
    args = parser.parse_args(argv)
    return _apply_config_file(parser, args, argv)
