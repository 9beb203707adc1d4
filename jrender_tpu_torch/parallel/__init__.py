"""The parallel stack over torch.distributed (counterpart of ``jrender_tpu/parallel``):
device meshes, pixel-band sharded SoftRas and rays data-parallel NeRF."""
from .mesh import make_device_mesh, shard_batch, replicate
from .render import band_row_src, soft_rasterize_sharded
from .nerf import make_sharded_nerf_step, nerf_param_specs, shard_nerf_params
