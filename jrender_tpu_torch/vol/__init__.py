"""Volume rendering in plain PyTorch: rays, sampling, compositing, ray
marching and the chunked render pass (counterpart of ``jrender_tpu/vol``)."""
from .camera import pinhole_get_rays, get_rays, ndc_rays
from .integrator import sample, sample_pdf, integrator
from .ray_marching import render_rays
from .render_pass import render, batchify_rays
