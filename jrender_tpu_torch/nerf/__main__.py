"""Train a NeRF from a config file (the port's twin of demos/demo7-nerf.py):

    python -m jrender_tpu_torch.nerf --config configs/lego.txt [--device cpu] [--flag value ...]

It runs on the card unless ``--device`` names another device; the other
flags are the trainer's (``nerf/config.py``) and override the file.
"""
from __future__ import annotations

import argparse
import sys

from .config import parse_args
from .trainer import train


def main(argv=None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', default=None)
    known, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    train(parse_args(rest), device=known.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
