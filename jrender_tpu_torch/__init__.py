"""jrender_tpu_torch — the SoftRas and N3MR renderers and the volume/NeRF stack in PyTorch, with CUDA kernels for Hopper.

The port of ``jrender_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports neither JAX nor the JAX package.  Its entry points run on the
card unless the caller passes ``device='cpu'``, where each kernel's
plain PyTorch version runs instead.

It covers the two mesh rasterizers, forward and backward:
    Mesh, Renderer, SoftRenderer, SoftRasterizer, Transform, Lighting,
    soft_rasterize (differentiable, top-K truncated gradient),
    N3mrRasterizer, rasterize_rgbad, rasterize, rasterize_silhouettes,
    rasterize_depth (N3MR, with its hand-defined edge gradient),
    LaplacianLoss, FlattenLoss, neg_iou_loss, get_points_from_angles;
and the files and the scene: load_obj, save_obj (OBJ/MTL with texture
PNGs, read by imageio, PIL or the package's own PNG codec), Mesh.from_obj,
normal maps and texture-space SSS, Scene, Render, Light, Texture (the
scene graph's deferred pipeline with its screen-space effects); and the
volume renderer and NeRF (plain PyTorch, no kernel of its own): rays,
stratified and importance sampling and compositing (pinhole_get_rays,
ndc_rays, sample, sample_pdf, integrator, render_rays, render), the NeRF
MLP (NeRF, Embedder, get_embedder) and its trainer with its datasets,
config, checkpoints and profiling (train, create_nerf, parse_args,
render_full_image; ``python -m jrender_tpu_torch.nerf --config ...``);
and the parallel stack on torch.distributed, ``jrender_tpu_torch.parallel``
(make_device_mesh, shard_batch, replicate, soft_rasterize_sharded over
pixel bands, shard_nerf_params, make_sharded_nerf_step over rays).
"""

from .structures import Mesh, join_meshes_as_scene
from .renderer import Renderer, SoftRenderer, SoftRasterizer
from .transform import Transform, look, look_at, perspective, orthogonal, projection
from .lighting import Lighting, AmbientLighting, DirectionalLighting, lighting
from .ops.softras import soft_rasterize
from .ops.n3mr import (N3mrRasterizer, rasterize_rgbad, rasterize,
                       rasterize_silhouettes, rasterize_depth)
from .loss import LaplacianLoss, FlattenLoss, neg_iou_loss
from .io import load_obj, save_obj
from .scene import Scene, Render, Light, Texture
from .utils import get_points_from_angles
from .vol import (pinhole_get_rays, get_rays, ndc_rays, sample, sample_pdf, integrator,
                  render_rays, render, batchify_rays)
from .nerf import (NeRF, Embedder, get_embedder, nerf_apply, img2mse, mse2psnr, to8b,
                   parse_args, create_nerf, render_full_image, train)

__version__ = '0.1.0'
