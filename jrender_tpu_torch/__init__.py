"""jrender_tpu_torch — the SoftRas and N3MR renderers in PyTorch, with CUDA kernels for Hopper.

The port of ``jrender_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports neither JAX nor the JAX package.  Its entry points run on the
card unless the caller passes ``device='cpu'``, where each kernel's
plain PyTorch version runs instead.

So far it covers the two mesh rasterizers, forward and backward:
    Mesh, Renderer, SoftRenderer, SoftRasterizer, Transform, Lighting,
    soft_rasterize (differentiable, top-K truncated gradient),
    N3mrRasterizer, rasterize_rgbad, rasterize, rasterize_silhouettes,
    rasterize_depth (N3MR, with its hand-defined edge gradient),
    LaplacianLoss, FlattenLoss, neg_iou_loss, get_points_from_angles.
"""

from .structures import Mesh, join_meshes_as_scene
from .renderer import Renderer, SoftRenderer, SoftRasterizer
from .transform import Transform, look, look_at, perspective, orthogonal, projection
from .lighting import Lighting, AmbientLighting, DirectionalLighting, lighting
from .ops.softras import soft_rasterize
from .ops.n3mr import (N3mrRasterizer, rasterize_rgbad, rasterize,
                       rasterize_silhouettes, rasterize_depth)
from .loss import LaplacianLoss, FlattenLoss, neg_iou_loss
from .utils import get_points_from_angles

__version__ = '0.1.0'
