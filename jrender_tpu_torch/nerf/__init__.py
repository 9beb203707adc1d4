"""The NeRF stack in plain PyTorch: the MLP and its encoding, the config,
the dataset loaders and the trainer (counterpart of ``jrender_tpu/nerf``).

    python -m jrender_tpu_torch.nerf --config configs/lego.txt [--device cpu]
"""
from .model import (NeRF, Embedder, get_embedder, init_nerf_params, nerf_apply,
                    img2mse, mse2psnr, to8b)
from .dataset import load_blender_data, load_llff_data, load_dv_data
from .config import config_parser, parse_args
from .trainer import create_nerf, render_full_image, render_path, train
