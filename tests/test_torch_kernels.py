"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  Without a card every test skips.  On a
machine with one, run it without the suite's conftest (which imports
JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Forward tolerance: atol 1e-4 with at most 1% of pixels beyond it.  The
kernel rounds the barycentrics, the clip and the texel selector exactly as
the plain version does, but nvcc may contract the continuous terms into
FMAs and expf differs from the CPU's exp in the last ulp, which moves
knife-edge pixels.

Threshold: the kernel's depth is computed with the plain version's
operations in its order, so the maps agree to 1e-6 relative except at
pixels where a pair sits on the edge of a validity test (at most 0.1%;
chip_smoke.py's readings are below 0.005%).

Backward tolerance: atol = 2e-3 * max|grad| and rtol = 2e-3, the JAX
suite's own (tests/test_softras_pallas.py:126-128): a gradient is a sum
over thousands of pixels taken in another order than the plain version's,
of terms amplified by 1/sigma and 1/gamma.  A knife-edge pair moves one
face's entries, so 0.1% of the entries may lie beyond it (chip_smoke.py
reads at most 0.01%), and none of the big faces' rows, which a kernel of
their own computes.  Two knife edges are systematic and are taken out of
the comparison (``jrender_tpu_torch/utils/checks.py`` has the helpers):

* A soft pixel outside a face has its clipped barycentric point on an
  edge, where wc0 + wc1 = 1 puts the texel selector exactly on its
  diagonal, and the last bit decides between texel i and texel T-1-i.
  PyTorch's CUDA arithmetic and the kernel's do not round alike there.
  So the textures are made equal on the two sides of the tie
  (``tie_symmetric``), which makes the face gradient independent of it,
  and the texture gradients are compared folded over each tie pair
  (``fold_ties``).
* The backward keeps a pair when ``zp <= thr`` and thr is the zp of the
  pixel's K-th candidate: the plain version on the card does not
  reproduce the kernel's depth bits, so with the kernel's threshold it
  would drop that candidate at some pixels.  Each side therefore takes
  the threshold computed its own way; the two maps are held together by
  the threshold test.
"""
import numpy as np
import pytest
import torch

from jrender_tpu_torch.ops.softras import binning, cuda_impl, make_params, torch_impl
from jrender_tpu_torch.utils.checks import fold_ties, grad_beyond, tie_symmetric

GRAD_FRAC = 0.001     # share of gradient entries allowed beyond the tolerance
THR_FRAC = 0.001      # share of pixels whose threshold may differ


def soup(seed, F, B=1, T=25, radius=(0.03, 0.3)):
    """Random well-shaped triangles in front of the camera."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.8, 0.8, (B, F, 1, 2))
    r = rng.uniform(*radius, (B, F, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.arange(3) * 2 * np.pi / 3 \
        + rng.uniform(-0.3, 0.3, (B, F, 3))
    xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    z = 2.5 + rng.uniform(-0.4, 0.4, (B, F, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9)
    tex = rng.uniform(size=(B, F, T, 3)).astype(np.float32)
    return torch.tensor(fv, device='cuda'), torch.tensor(tex, device='cuda')


def mostly_close(a, b, atol, frac=0.01):
    bad = (a.double() - b.double()).abs() > atol
    if bad.dim() == 4:
        bad = bad.any(dim=1)
    assert torch.isfinite(a).all()
    assert bad.float().mean().item() <= frac, \
        f'{bad.float().mean().item():.4f} beyond {atol}; max {(a - b).abs().max().item():.3g}'


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum'),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard'),
    dict(texture_type='vertex', background_color=(0.1, 0.2, 0.3), fill_back=False),
], ids=['default', 'bary-sum', 'hard', 'vertex-bg'])
def test_softras_fwd_kernel_matches_plain(kw):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    vertex = kw.get('texture_type') == 'vertex'
    x, t = soup(0, F=300, B=2, T=3 if vertex else 25)
    if vertex:
        t = t.reshape(2, 300, 3, 3)
    p = make_params(image_size=72, **kw)      # 72 px: a ragged last tile
    img, ag, cnt = cuda_impl.launch(cuda_impl.prepare(x, t, p), p)
    torch.cuda.synchronize()
    want, ag_w, cnt_w = torch_impl.soft_rasterize_fwd_plain(x, t, p)
    mostly_close(img[:, :3], want[:, :3], 1e-4)
    mostly_close(img[:, 3], want[:, 3], 1e-4)
    mostly_close(cnt.float(), cnt_w.float(), 0)
    if p.aggr_func_rgb == 'hard':
        mostly_close(ag[:, 1], ag_w[:, 1], 0)            # winning face id
        mostly_close(ag[:, 0], ag_w[:, 0], 1e-4)         # its depth


@pytest.mark.gpu
def test_softras_fwd_kernel_checks_its_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(1, F=20)
    p = make_params(image_size=32)
    inputs = cuda_impl.prepare(x, t, p)
    with pytest.raises(TypeError):
        cuda_impl.launch(inputs._replace(rows=inputs.rows.double()), p)
    with pytest.raises(ValueError):
        cuda_impl.launch(inputs._replace(rows=inputs.rows[:, :10]), p)
    with pytest.raises(ValueError):
        cuda_impl.launch(inputs._replace(rows=inputs.rows.transpose(0, 1)), p)


def grad_close(got, want, frac=GRAD_FRAC, faces=None):
    """atol 2e-3 * max|want|, rtol 2e-3, all but ``frac`` of the entries
    (of the rows of ``faces`` [B,F], where given)."""
    share, err = grad_beyond(got, want, faces)
    assert share <= frac, \
        f'{share:.5f} of entries beyond tolerance (allowed {frac}); max diff {err:.3g} of scale'


def with_big_faces(x):
    """Make the first two faces span most of the screen (the big-face list)."""
    x = x.clone()
    x[:, 0, 0::3] = torch.tensor([-0.9, 0.9, 0.0], device='cuda')
    x[:, 0, 1::3] = torch.tensor([-0.9, -0.8, 0.9], device='cuda')
    x[:, 1, 0::3] = torch.tensor([-0.8, 0.7, -0.9], device='cuda')
    x[:, 1, 1::3] = torch.tensor([0.8, 0.9, -0.7], device='cuda')
    return x


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 4, 16, 40])
@pytest.mark.parametrize('dist_func', ['euclidean', 'hard'])
def test_softras_thr_kernel_matches_plain(K, dist_func):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    # K = 40 is past the kernel's per-thread list and takes its bisection;
    # it needs a soup dense enough for pixels with more than 40 candidates
    x, t = soup(2, F=600, B=2, T=1, radius=(0.3, 0.6)) if K >= 16 else \
        soup(2, F=300, B=2, T=1)
    x = with_big_faces(x)
    p = make_params(image_size=72, sigma_val=1e-3, dist_func=dist_func,
                    max_faces_per_pixel_for_grad=K)
    inputs = cuda_impl.prepare(x, t, p)
    _, _, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.launch_thr(inputs, counts, p)
    torch.cuda.synchronize()
    want = torch_impl.topk_threshold_plain(x, p)
    assert (counts > K).any() and (counts <= K).any()
    bad = (thr - want).abs() > 1e-6 * want.abs()
    assert bad.float().mean().item() <= THR_FRAC, bad.float().mean().item()
    # where a pixel has at most K candidates the threshold does not bind
    assert (thr[counts <= K] == p.far).all()


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum'),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard'),
    # no front-side check in the backward: gamma must keep exp((zpn - M) /
    # gamma) of a lone back face within float32
    dict(texture_type='vertex', fill_back=False, gamma_val=0.1),
    dict(grad_mode='full'),
    dict(max_faces_per_pixel_for_grad=4),
], ids=['default', 'bary-sum', 'hard', 'vertex', 'full', 'K4'])
def test_softras_bwd_kernels_match_plain(kw):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    vertex = kw.get('texture_type') == 'vertex'
    x, t = soup(3, F=300, B=2, T=3 if vertex else 4)
    x = with_big_faces(x)
    t = t.reshape(2, 300, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=72, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
    # an emit cap of 6: a face spanning more than 6 of the 25 tiles is a big face
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    inputs = inputs._replace(lists=binning.build_tile_lists_compact(
        x, 72, cuda_impl.TILE, cuda_impl.TILE, p.threshold, 6, with_inverse=True))
    assert int(inputs.lists.gcount.min()) >= 2
    img, ag, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.topk_threshold(x, p, inputs, counts)
    assert (thr is None) == (kw.get('grad_mode') == 'full')
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    gf, gt = cuda_impl.soft_rasterize_bwd(x, t, img, ag, thr, g, p, inputs)
    gf2, gt2 = cuda_impl.soft_rasterize_bwd(x, t, img, ag, thr, g, p, inputs)
    torch.cuda.synchronize()
    # no atomics, every sum in a fixed order: the same bits every time
    assert torch.equal(gf, gf2) and torch.equal(gt, gt2)
    # the plain version on the kernel's forward outputs and its own threshold
    thr_plain = None if thr is None else torch_impl.topk_threshold_plain(x, p)
    wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, thr_plain, g, p)
    assert gf.shape == wf.shape and gt.shape == wt.shape
    if not vertex:
        gt, wt = fold_ties(gt), fold_ties(wt)
    grad_close(gf, wf)
    grad_close(gt, wt)
    # the big faces take a kernel of their own: their rows, no entry beyond
    big = inputs.lists.gpos >= 0
    grad_close(gf, wf, frac=0.0, faces=big)
    grad_close(gt, wt, frac=0.0, faces=big)


@pytest.mark.gpu
def test_soft_rasterize_backward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import soft_rasterize
    x, t = soup(4, F=200, T=4)
    x.requires_grad_(True)
    t.requires_grad_(True)
    counts = [w.launches for w in (cuda_impl.launch, cuda_impl.launch_thr,
                                   cuda_impl.launch_bwd, cuda_impl.launch_reduce)]
    with torch.no_grad():
        soft_rasterize(x, t, image_size=64, sigma_val=1e-3)
    after = [w.launches for w in (cuda_impl.launch, cuda_impl.launch_thr,
                                  cuda_impl.launch_bwd, cuda_impl.launch_reduce)]
    assert [a - b for a, b in zip(after, counts)] == [1, 0, 0, 0]   # a plain forward
    img = soft_rasterize(x, t, image_size=64, sigma_val=1e-3)
    img.sum().backward()
    torch.cuda.synchronize()
    last = [w.launches for w in (cuda_impl.launch, cuda_impl.launch_thr,
                                 cuda_impl.launch_bwd, cuda_impl.launch_reduce)]
    assert [a - b for a, b in zip(last, after)] == [1, 1, 1, 1]
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


@pytest.mark.gpu
def test_softras_bwd_wrappers_check_their_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(1, F=20)
    p = make_params(image_size=32)
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    img, ag, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.launch_thr(inputs, counts, p)
    g = torch.ones_like(img)
    with pytest.raises(TypeError):
        cuda_impl.launch_thr(inputs, counts.float(), p)
    with pytest.raises(ValueError):
        cuda_impl.launch_thr(inputs, counts[:, :16], p)
    with pytest.raises(ValueError):
        cuda_impl.launch_thr(inputs, counts.cpu(), p)
    with pytest.raises(ValueError):
        cuda_impl.launch_bwd(inputs, img, ag, thr, g[:, :3], p)
    with pytest.raises(TypeError):
        cuda_impl.launch_bwd(inputs, img, ag, thr.double(), g, p)
    with pytest.raises(ValueError):
        cuda_impl.launch_bwd(inputs, img.cpu(), ag, thr, g, p)
    rows = cuda_impl.launch_bwd(inputs, img, ag, thr, g, p)
    with pytest.raises(ValueError, match='for_grad'):
        cuda_impl.launch_reduce(cuda_impl.prepare(x, t, p), rows, p)
    with pytest.raises(ValueError):
        cuda_impl.launch_reduce(inputs, rows._replace(gbig=rows.gbig[:, :5]), p)
