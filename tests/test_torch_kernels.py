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

The N3MR kernels' tests and tolerances follow the SoftRas ones; the dir,
pxg, f_px and px_f routes' come after them, then the fixed-order sums
(``ops/segment_sum.py``).  The f_px and px_f gradients are held to the
binned route's kernels on every entry (the two compute the same pairs)
and to the plain version on all but 0.1% of the entries, not counting an
entry where the plain version in float64 shows the float32 plain version
itself to be off by at least a quarter of the difference: a knife-edge
pixel (``grad_close_or_knife_edge``, ``checks.grad_unexplained``).
"""
import numpy as np
import pytest
import torch

from jrender_tpu_torch.ops.softras import binning, cuda_impl, make_params, torch_impl
from jrender_tpu_torch.utils.checks import (fold_ties, grad_beyond, grad_unexplained,
                                            tie_symmetric)

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


# ---- N3MR: the z-buffer, the texture gradient, the edge gradient ------------
#
# The z-buffer kernel repeats the plain version's arithmetic with
# round-to-nearest intrinsics, operation by operation, so the winners agree
# except where two faces' depths differ in the last bits (at most 0.1% of the
# pixels, and there the two depths agree to 1e-6 relative:
# ``checks.n3mr_maps_beyond``).  The gradients sum the same float32 terms in
# another order than the plain version: atol 2e-5 * max|grad|, the JAX suite's
# own for its two versions (tests/test_n3mr.py:196-198, 338-340).

def n3mr_soup(seed, F, B=1, shrink=1.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.95, 0.95, size=(B, F, 3, 2))
    ctr = xy.mean(2, keepdims=True)
    xy = ctr + (xy - ctr) * shrink
    z = rng.uniform(1.2, 4.0, size=(B, F, 3, 1))
    return torch.tensor(np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9),
                        device='cuda')


def n3mr_textures(seed, B, F, ts):
    return torch.tensor(np.random.RandomState(seed).rand(B, F, ts, ts, ts, 3)
                        .astype(np.float32), device='cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('is_,ts,special', [(64, 2, False), (72, 4, True), (128, 1, True),
                                            (64, None, False)],
                         ids=['64-ts2', '72-ragged-ts4-special', '128-ts1-special', 'no-rgb'])
def test_n3mr_maps_kernel_matches_plain(is_, ts, special):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import n3mr_maps_beyond, n3mr_special_faces
    face = n3mr_soup(0, 200, B=2, shrink=0.5)
    if special:
        face = n3mr_special_faces(face)
    tex = None if ts is None else n3mr_textures(1, 2, 200, ts)
    rows, *got = ncuda.forward_maps(face, tex, is_, 0.1, 100.0, 1e-3)
    torch.cuda.synchronize()
    want = list(nplain.forward_maps(face, is_, 0.1, 100.0))
    want.append(None if tex is None else
                nplain.trilinear_rgb_from_maps(tex, *want[:3], want[4], 1e-3))
    assert (got[5] is None) == (tex is None)
    n3mr_maps_beyond(got, want)
    assert (got[0] >= 0).float().mean() > 0.2
    if special:
        assert (got[0] == 0).any() and not ((got[0] == 1) | (got[0] == 2)).any()
        # an emit cap of 4 tiles sends most faces through the big-face list:
        # the same maps, bit for bit
        neg_y = face * face.new_tensor([1.0, -1.0, 1.0] * 3)
        lists = binning.build_tile_lists_compact(neg_y, is_, ncuda.TILE, ncuda.TILE, 0.0, 4)
        assert int(lists.gcount.min()) >= 10
        big = ncuda.launch_maps(rows, lists, tex, is_, 0.1, 100.0, 1e-3)
        assert all(torch.equal(a, b) for a, b in zip(got, big))


@pytest.mark.gpu
@pytest.mark.parametrize('ts', [1, 2, 4, 6, 7, 9])
def test_n3mr_texbwd_kernel_matches_plain(ts):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, n3mr_special_faces, scaled_err
    face = n3mr_special_faces(n3mr_soup(2, 150, B=2, shrink=0.6))
    tex = n3mr_textures(3, 2, 150, ts)
    rows, fi, wt, dp, finv, zc, rgb = ncuda.forward_maps(face, tex, 72, 0.1, 100.0, 1e-3)
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(rgb.shape, generator=gen, device='cuda')
    got = ncuda.backward_textures(rows, tex.shape, fi, wt, dp, zc, g, 1e-3)
    again = ncuda.backward_textures(rows, tex.shape, fi, wt, dp, zc, g, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # no atomics: the same bits
    want = nplain.backward_textures(tex.shape, fi, wt, dp, zc, g, 1e-3)
    assert scaled_err(got, want) <= N3MR_SUM_TOL
    assert got[:, 0].abs().max() > 0          # the screen-filling face
    assert (got[:, 1:3] == 0).all()           # the degenerate faces


@pytest.mark.gpu
@pytest.mark.parametrize('rr,ra', [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize('is_', [64, 72])
def test_n3mr_edgebwd_kernel_matches_plain(rr, ra, is_):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, n3mr_special_faces, scaled_err
    face = n3mr_special_faces(n3mr_soup(4, 120, B=2, shrink=0.8))
    tex = n3mr_textures(5, 2, 120, 2)
    rows, fi, wt, dp, finv, zc, rgb = ncuda.forward_maps(face, tex, is_, 0.1, 100.0, 1e-3)
    alpha = (fi >= 0).float()
    gen = torch.Generator(device='cuda').manual_seed(6)
    gr = torch.randn(rgb.shape, generator=gen, device='cuda')
    ga = torch.randn(alpha.shape, generator=gen, device='cuda')
    args = (face, fi, rgb, alpha, gr, ga, is_, 1e-3, rr, ra)
    got = ncuda.backward_pixel_map(*args)
    again = ncuda.backward_pixel_map(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = nplain.backward_pixel_map(*args)
    assert scaled_err(got, want) <= N3MR_SUM_TOL
    assert (got[..., 2::3] == 0).all() and got.abs().max() > 0


@pytest.mark.gpu
def test_n3mr_rasterize_backward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, rasterize
    wrappers = (ncuda.launch_maps, ncuda.launch_texbwd, ncuda.launch_edgebwd)
    x = n3mr_soup(7, 100).reshape(1, 100, 3, 3).requires_grad_(True)
    t = n3mr_textures(8, 1, 100, 2).requires_grad_(True)
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        rasterize(x, t, 64)
    after = [w.launches for w in wrappers]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]      # a plain forward
    rasterize(x, t, 64).sum().backward()
    torch.cuda.synchronize()
    last = [w.launches for w in wrappers]
    assert [a - b for a, b in zip(last, after)] == [1, 1, 1]
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


@pytest.mark.gpu
def test_n3mr_wrappers_check_their_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    face = n3mr_soup(9, 20)
    tex = n3mr_textures(9, 1, 20, 2)
    rows, fi, wt, dp, finv, zc, rgb = ncuda.forward_maps(face, tex, 32, 0.1, 100.0, 1e-3)
    lists = ncuda.tile_lists(face, 32)
    with pytest.raises(TypeError):
        ncuda.launch_maps(rows.double(), lists, tex, 32, 0.1, 100.0, 1e-3)
    with pytest.raises(ValueError):
        ncuda.launch_maps(rows[:, :, :10], lists, tex, 32, 0.1, 100.0, 1e-3)
    with pytest.raises(ValueError):
        ncuda.launch_maps(rows, lists, tex[:, :10], 32, 0.1, 100.0, 1e-3)
    with pytest.raises(ValueError):
        ncuda.launch_texbwd(rows, tex.shape, fi, wt[..., :2], dp, zc, rgb, 1e-3)
    with pytest.raises(TypeError):
        ncuda.launch_texbwd(rows, tex.shape, fi.long(), wt, dp, zc, rgb, 1e-3)
    alpha = (fi >= 0).float()
    pp, fi2, planes = ncuda.edge_inputs(face, fi, rgb, alpha, rgb, alpha, 32, True, True)
    with pytest.raises(ValueError):
        ncuda.launch_edgebwd(pp, fi2, planes, 1e-3, False, False)
    with pytest.raises(ValueError):
        ncuda.launch_edgebwd(pp, fi2, planes.cpu(), 1e-3, True, True)
    with pytest.raises(ValueError):
        ncuda.launch_edgebwd(pp, fi2, planes, 1e-3, True, False)     # 8 planes, 6 expected
    with pytest.raises(ValueError):
        ncuda.launch_edgebwd(pp, fi2.transpose(2, 3), planes, 1e-3, True, True)


# ---- the dir route: K10 forward (with the threshold) and K11 backward --------
#
# The dir kernels read the face table in Morton order (dir_impl.prep_dir) and
# are held against their plain versions at the binned kernels' tolerances,
# and against the binned route on the same inputs: the candidate counts and
# the threshold come from the same pair math, so those maps agree to the bit.


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum', max_faces_per_pixel_for_grad=4),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard',
         max_faces_per_pixel_for_grad=2),
    dict(texture_type='vertex', fill_back=False, gamma_val=0.1),
    dict(grad_mode='full'),
    dict(max_faces_per_pixel_for_grad=40),
], ids=['default', 'bary-sum-K4', 'hard-K2', 'vertex', 'full', 'K40'])
@pytest.mark.parametrize('size', [64, 72])
def test_softras_dir_kernels_match_plain_and_binned(kw, size):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    vertex = kw.get('texture_type') == 'vertex'
    dense = kw.get('max_faces_per_pixel_for_grad') == 40
    x, t = soup(6, F=600 if dense else 300, B=2, T=3 if vertex else 4,
                radius=(0.3, 0.6) if dense else (0.03, 0.3))
    x = with_big_faces(x)
    F = x.shape[1]
    t = t.reshape(2, F, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=size, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
    with_thr = torch_impl.use_threshold(p, F)
    table = dir_impl.prep_dir(x, t, p)
    img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, p, with_thr)
    torch.cuda.synchronize()
    want, ag_w, cnt_w, thr_w = dir_impl.fwd_plain(table, p, with_thr)
    mostly_close(img[:, :3], want[:, :3], 1e-4)
    mostly_close(img[:, 3], want[:, 3], 1e-4)
    mostly_close(cnt.float(), cnt_w.float(), 0)
    if p.aggr_func_rgb == 'hard':
        mostly_close(ag[:, 1], ag_w[:, 1], 0)            # winning original face id
    # the binned route on the same inputs: counts and thresholds to the bit
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    b_img, b_ag, b_cnt = cuda_impl.launch(inputs, p)
    b_thr = cuda_impl.topk_threshold(x, p, inputs, b_cnt)
    assert torch.equal(cnt, b_cnt)
    assert (thr is None) == (b_thr is None) == (not with_thr)
    if with_thr:
        assert (cnt > p.max_faces_id).any()
        assert torch.equal(thr, b_thr)
        bad = (thr - thr_w).abs() > 1e-6 * thr_w.abs()
        assert bad.float().mean().item() <= THR_FRAC
    mostly_close(img, b_img, 1e-4)
    # the backward: twice to the bit, against the plain version (with its
    # own threshold) and the binned backward
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    gf, gt = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
    gf2, gt2 = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
    torch.cuda.synchronize()
    assert torch.equal(gf, gf2) and torch.equal(gt, gt2)
    wf, wt = dir_impl.bwd_plain(table, img, ag, thr_w, g, p)
    kf, kt = cuda_impl.soft_rasterize_bwd(x, t, b_img, b_ag, b_thr, g, p, inputs)
    if not vertex:
        gt, wt, kt = fold_ties(gt), fold_ties(wt), fold_ties(kt)
    for got, want_, binned in ((gf, wf, kf), (gt, wt, kt)):
        grad_close(got, want_)
        grad_close(got, binned)
    assert gf[:, :2].abs().amax() > 0 or p.dist_func == 'hard'   # the screen-filling faces


@pytest.mark.gpu
def test_soft_rasterize_dir_route_on_the_card(monkeypatch):
    """With JR_DIR_MAX >= F a frame launches the dir forward once and a step
    each dir kernel once, and nothing of the binned route; without it the
    dir kernels never run."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl, soft_rasterize
    wrappers = (cuda_impl.launch, cuda_impl.launch_thr, cuda_impl.launch_bwd,
                cuda_impl.launch_reduce, dir_impl.launch_dir_fwd, dir_impl.launch_dir_bwd)
    x, t = soup(7, F=200, T=4)
    x.requires_grad_(True)
    t.requires_grad_(True)

    def counts():
        return [w.launches for w in wrappers]

    monkeypatch.setenv('JR_DIR_MAX', '200')
    before = counts()
    with torch.no_grad():
        soft_rasterize(x, t, image_size=64, sigma_val=1e-3)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 0, 1, 0]
    soft_rasterize(x, t, image_size=64, sigma_val=1e-3).sum().backward()
    torch.cuda.synchronize()
    last = counts()
    assert [a - b for a, b in zip(last, after)] == [0, 0, 0, 0, 1, 1]
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    monkeypatch.delenv('JR_DIR_MAX')
    soft_rasterize(x, t, image_size=64, sigma_val=1e-3).sum().backward()
    assert [a - b for a, b in zip(counts(), last)] == [1, 1, 1, 1, 0, 0]


@pytest.mark.gpu
def test_softras_dir_wrappers_check_their_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    x, t = soup(1, F=20)
    p = make_params(image_size=32)
    table = dir_impl.prep_dir(x, t, p)
    img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, p, True)
    g = torch.ones_like(img)
    with pytest.raises(TypeError):
        dir_impl.launch_dir_fwd(table._replace(rows=table.rows.double()), p, False)
    with pytest.raises(ValueError):
        dir_impl.launch_dir_fwd(table._replace(bbox=table.bbox[:, :5]), p, False)
    with pytest.raises(TypeError):
        dir_impl.launch_dir_fwd(table._replace(ids=table.ids.long()), p, False)
    with pytest.raises(ValueError, match='divisible'):
        dir_impl.launch_dir_fwd(table, make_params(image_size=36), False)
    with pytest.raises(ValueError):
        dir_impl.launch_dir_bwd(table, img, ag, thr, g[:, :3], p)
    with pytest.raises(ValueError):
        dir_impl.launch_dir_bwd(table, img.cpu(), ag, thr, g, p)


# ---- the pxg route: K7 partials and combine, K8 threshold, K9 backward and sum --
#
# The pxg kernels read the binned route's rows and tile lists, cut into work
# items (pxg_impl.prep_pxg); a group of 8 faces splits nearly every tile.  They
# are held against their plain versions at the binned kernels' tolerances and
# against the binned route on the same inputs: counts and thresholds come
# from the same pair math, so those maps agree to the bit, and so do the
# hard winners.


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum', max_faces_per_pixel_for_grad=4),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard',
         max_faces_per_pixel_for_grad=2),
    dict(texture_type='vertex', fill_back=False, gamma_val=0.1,
         background_color=(0.1, 0.2, 0.3)),
    dict(grad_mode='full'),
    dict(max_faces_per_pixel_for_grad=40),
], ids=['default', 'bary-sum-K4', 'hard-K2', 'vertex-bg', 'full', 'K40'])
@pytest.mark.parametrize('group', [8, 64])
def test_softras_pxg_kernels_match_plain_and_binned(kw, group):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxg_impl, tiled
    vertex = kw.get('texture_type') == 'vertex'
    dense = kw.get('max_faces_per_pixel_for_grad') == 40
    x, t = soup(8, F=600 if dense else 300, B=2, T=3 if vertex else 4,
                radius=(0.3, 0.6) if dense else (0.03, 0.3))
    x = with_big_faces(x)
    F = x.shape[1]
    t = t.reshape(2, F, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=72, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
    with_thr = torch_impl.use_threshold(p, F)
    pin = pxg_impl.prep_pxg(x, t, p, for_grad=True, group=group)
    parts, depths = pxg_impl.launch_pxg_fwd(pin, p, with_thr)
    img, ag, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
    torch.cuda.synchronize()
    w_parts, w_depths = pxg_impl.fwd_partials_plain(pin, p, with_thr)
    assert torch.equal(parts[:, 6], w_parts[:, 6])                       # counts
    mostly_close(parts.permute(0, 2, 1), w_parts.permute(0, 2, 1), 1e-4)
    # the combine alone, on the kernel's partials, and the whole plain chain
    c_img, c_ag, c_cnt = pxg_impl.combine_plain(pin, parts, p)
    mostly_close(img, c_img, 1e-5, frac=0.0)
    assert torch.equal(cnt, c_cnt)
    w_img, _, w_cnt = pxg_impl.combine_plain(pin, w_parts, p)
    mostly_close(img[:, :3], w_img[:, :3], 1e-4)
    mostly_close(img[:, 3], w_img[:, 3], 1e-4)
    # the binned route on the same inputs
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    b_img, b_ag, b_cnt = cuda_impl.launch(inputs, p)
    b_thr = cuda_impl.topk_threshold(x, p, inputs, b_cnt)
    assert torch.equal(cnt, b_cnt)
    mostly_close(img, b_img, 1e-4)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag, b_ag) and torch.equal(img[:, :3], b_img[:, :3])
    thr = pxg_impl.launch_pxg_thr(pin, depths, cnt, p) if with_thr else None
    thr_w = pxg_impl.thr_plain(pin, w_depths, cnt, p) if with_thr else None
    if with_thr:
        assert (cnt > p.max_faces_id).any()
        assert torch.equal(thr, b_thr)
        bad = (thr - thr_w).abs() > 1e-6 * thr_w.abs()
        assert bad.float().mean().item() <= THR_FRAC
    # the backward: twice to the bit; the entry rows and the whole gradient
    # against the plain versions (with their own threshold), the face sum
    # against its plain version on the same rows, and the binned backward
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    grows = pxg_impl.launch_pxg_bwd(pin, img, ag, thr, g, p)
    gf, gt = tiled.face_sum(pin, grows, p)
    gf2, gt2 = pxg_impl.backward(pin, img, ag, thr, g, p)
    torch.cuda.synchronize()
    assert torch.equal(gf, gf2) and torch.equal(gt, gt2)
    sf_, st_ = tiled.sum_plain(pin, grows, p)
    grad_close(gf, sf_, frac=0.0)
    grad_close(gt, st_, frac=0.0)
    rows_w = pxg_impl.bwd_rows_plain(pin, img, ag, thr_w, g, p)
    grad_close(grows[:, :9], rows_w[:, :9])
    wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, thr_w, g, p)
    kf, kt = cuda_impl.soft_rasterize_bwd(x, t, b_img, b_ag, b_thr, g, p, inputs)
    if not vertex:
        gt, wt, kt = fold_ties(gt), fold_ties(wt), fold_ties(kt)
    for got, want_, binned in ((gf, wf, kf), (gt, wt, kt)):
        grad_close(got, want_)
        grad_close(got, binned)
    assert gf[:, :2].abs().amax() > 0 or p.dist_func == 'hard'   # the screen-filling faces


@pytest.mark.gpu
def test_soft_rasterize_pxg_route_on_the_card(monkeypatch):
    """Under JR_LAYOUT=pxg a frame launches the pxg partials and combine
    once, a step each pxg kernel once, and nothing of the binned or dir
    routes; with JR_LAYOUT unset the pxg kernels never run."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.segment_sum import launch_segment_sum
    from jrender_tpu_torch.ops.softras import dir_impl, pxg_impl, soft_rasterize
    wrappers = (cuda_impl.launch, cuda_impl.launch_thr, cuda_impl.launch_bwd,
                cuda_impl.launch_reduce, dir_impl.launch_dir_fwd, dir_impl.launch_dir_bwd,
                pxg_impl.launch_pxg_fwd, pxg_impl.launch_pxg_combine, pxg_impl.launch_pxg_thr,
                pxg_impl.launch_pxg_bwd, launch_segment_sum)
    x, t = soup(9, F=600, T=4, radius=(0.3, 0.6))
    x.requires_grad_(True)
    t.requires_grad_(True)

    def counts():
        return [w.launches for w in wrappers]

    monkeypatch.setenv('JR_LAYOUT', 'pxg')
    monkeypatch.setenv('JR_DIR_MAX', '4096')             # the pxg layout never takes dir
    before = counts()
    with torch.no_grad():
        soft_rasterize(x, t, image_size=64, sigma_val=1e-3)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0] * 6 + [1, 1, 0, 0, 0]
    soft_rasterize(x, t, image_size=64, sigma_val=1e-3).sum().backward()
    torch.cuda.synchronize()
    last = counts()
    assert [a - b for a, b in zip(last, after)] == [0] * 6 + [1] * 5
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    monkeypatch.setenv('JR_LAYOUT', 'px_f')           # its own kernels: none of these
    with torch.no_grad():
        soft_rasterize(x, t, image_size=64, sigma_val=1e-3)
    assert counts() == last
    monkeypatch.delenv('JR_LAYOUT')
    monkeypatch.delenv('JR_DIR_MAX')
    soft_rasterize(x, t, image_size=64, sigma_val=1e-3).sum().backward()
    assert [a - b for a, b in zip(counts(), last)] == [1, 1, 1, 1] + [0] * 7


@pytest.mark.gpu
def test_softras_pxg_wrappers_check_their_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxg_impl, tiled
    x, t = soup(1, F=40)
    p = make_params(image_size=32, max_faces_per_pixel_for_grad=1)
    pin = pxg_impl.prep_pxg(x, t, p, for_grad=True, group=8)
    parts, depths = pxg_impl.launch_pxg_fwd(pin, p, True)
    img, ag, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
    g = torch.ones_like(img)
    with pytest.raises(TypeError):
        pxg_impl.launch_pxg_fwd(pin._replace(rows=pin.rows.double()), p, False)
    with pytest.raises(TypeError):
        pxg_impl.launch_pxg_fwd(pin._replace(items=pin.items.long()), p, False)
    with pytest.raises(ValueError):
        pxg_impl.launch_pxg_combine(pin, parts[:, :7], p)
    with pytest.raises(ValueError):
        pxg_impl.launch_pxg_thr(pin, None, cnt, p)                 # K = 1 has depth lists
    with pytest.raises(ValueError):
        pxg_impl.launch_pxg_bwd(pin, img, ag, None, g[:, :3], p)
    rows = pxg_impl.launch_pxg_bwd(pin, img, ag, None, g, p)
    with pytest.raises(ValueError):
        tiled.face_sum(pin._replace(face_off=None), rows, p)
    with pytest.raises(ValueError):
        tiled.face_sum(pin, rows[:, :5], p)


# ---- the f_px route (K3 forward, K4 untruncated backward) and the px_f route
# (K5 forward with the threshold, K6 backward), by bands ------------------------
#
# Both read the binning at their own tile shape, written out tile after tile
# (tiled.prep).  They are held against their plain versions at the binned
# kernels' tolerances and against the binned route on the same inputs: counts,
# thresholds and hard winners come from the same pair math, so those maps agree
# to the bit.  K4 is untruncated: it is compared at grad_mode='full', or where
# K >= F.  Alpha 'prod' multiplies in list order on both routes.


def grad_close_or_knife_edge(got, want, exact, binned):
    """``got`` within ``grad_close`` of the binned route's kernels on every
    entry (they compute the same pairs, another order), and of the plain
    version ``want`` on all but GRAD_FRAC of the entries that its own
    rounding does not explain: a knife-edge pixel of a face (a tie of two
    barycentrics that picks the gradient's inverse row, a pair on the
    distance cut) falls one way in PyTorch's CUDA arithmetic and the other
    in the kernels', and moves all of that face's entries; ``exact``, the
    plain version in float64, shows where the float32 plain version is
    itself that far off (``checks.grad_unexplained``)."""
    grad_close(got, binned, frac=0.0)
    share, err = grad_unexplained(got, want, exact)
    assert share <= GRAD_FRAC, \
        f'{share:.5f} of entries beyond tolerance and not rounding; max {err:.3g} of scale'


def plain64(x, t, g, p, with_thr):
    """The plain forward, threshold and backward in float64 on the same
    inputs: (grad_face_vertices, grad_textures)."""
    x, t = x.double(), t.double()
    img, ag, _ = torch_impl.soft_rasterize_fwd_plain(x, t, p)
    thr = torch_impl.topk_threshold_plain(x, p) if with_thr else None
    return torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, thr, g.double(), p)


def _binned(x, t, p):
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    img, ag, cnt = cuda_impl.launch(inputs, p)
    return inputs, img, ag, cnt, cuda_impl.topk_threshold(x, p, inputs, cnt)


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(grad_mode='full'),
    dict(dist_func='barycentric', aggr_func_alpha='sum', grad_mode='full'),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard', grad_mode='full'),
    dict(texture_type='vertex', fill_back=False, gamma_val=0.1, grad_mode='full'),
    dict(max_faces_per_pixel_for_grad=400),
], ids=['full', 'bary-sum', 'hard', 'vertex', 'K>=F'])
@pytest.mark.parametrize('size', [32, 48, 256])
def test_softras_fpx_kernels_match_plain_and_binned(kw, size):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import fpx_impl, tiled
    vertex = kw.get('texture_type') == 'vertex'
    x, t = soup(10, F=300, B=2, T=3 if vertex else 4)
    x = with_big_faces(x)
    F = x.shape[1]
    t = t.reshape(2, F, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=size, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
    assert not torch_impl.use_threshold(p, F)
    pin = fpx_impl.prep_fpx(x, t, p, for_grad=True)
    img, ag, cnt, _ = fpx_impl.launch_fpx_fwd(pin, p)
    torch.cuda.synchronize()
    want, ag_w, cnt_w, _ = tiled.fwd_plain(pin, p, False)
    mostly_close(img[:, :3], want[:, :3], 1e-4)
    mostly_close(img[:, 3], want[:, 3], 1e-4)
    mostly_close(cnt.float(), cnt_w.float(), 0)
    inputs, b_img, b_ag, b_cnt, b_thr = _binned(x, t, p)
    assert b_thr is None and torch.equal(cnt, b_cnt)
    mostly_close(img, b_img, 1e-4)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag, b_ag) and torch.equal(img[:, :3], b_img[:, :3])
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    grows = fpx_impl.launch_fpx_bwd(pin, img, ag, None, g, p)
    gf, gt = tiled.face_sum(pin, grows, p)
    gf2, gt2 = fpx_impl.backward(pin, img, ag, None, g, p)
    torch.cuda.synchronize()
    assert torch.equal(gf, gf2) and torch.equal(gt, gt2)
    sf_, st_ = tiled.sum_plain(pin, grows, p)
    grad_close(gf, sf_, frac=0.0)
    grad_close(gt, st_, frac=0.0)
    wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, None, g, p)
    xf, xt = plain64(x, t, g, p, False)
    kf, kt = cuda_impl.soft_rasterize_bwd(x, t, b_img, b_ag, None, g, p, inputs)
    if not vertex:
        gt, wt, xt, kt = fold_ties(gt), fold_ties(wt), fold_ties(xt), fold_ties(kt)
    for got, want_, exact, binned in ((gf, wf, xf, kf), (gt, wt, xt, kt)):
        grad_close_or_knife_edge(got, want_, exact, binned)


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum', max_faces_per_pixel_for_grad=4),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard',
         max_faces_per_pixel_for_grad=1),
    dict(texture_type='vertex', fill_back=False, gamma_val=0.1),
    dict(grad_mode='full'),
    dict(max_faces_per_pixel_for_grad=40),
], ids=['default', 'bary-sum-K4', 'hard-K1', 'vertex', 'full', 'K40'])
@pytest.mark.parametrize('size', [24, 64, 96])
def test_softras_pxf_kernels_match_plain_and_binned(kw, size):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxf_impl, tiled
    vertex = kw.get('texture_type') == 'vertex'
    dense = kw.get('max_faces_per_pixel_for_grad') == 40
    x, t = soup(11, F=600 if dense else 300, B=2, T=3 if vertex else 4,
                radius=(0.3, 0.6) if dense else (0.03, 0.3))
    x = with_big_faces(x)
    F = x.shape[1]
    t = t.reshape(2, F, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=size, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
    with_thr = torch_impl.use_threshold(p, F)
    pin = pxf_impl.prep_pxf(x, t, p, for_grad=True)
    img, ag, cnt, thr = pxf_impl.launch_pxf_fwd(pin, p, with_thr)
    torch.cuda.synchronize()
    want, ag_w, cnt_w, thr_w = tiled.fwd_plain(pin, p, with_thr)
    mostly_close(img[:, :3], want[:, :3], 1e-4)
    mostly_close(img[:, 3], want[:, 3], 1e-4)
    mostly_close(cnt.float(), cnt_w.float(), 0)
    inputs, b_img, b_ag, b_cnt, b_thr = _binned(x, t, p)
    assert torch.equal(cnt, b_cnt)
    assert (thr is None) == (b_thr is None) == (not with_thr)
    if with_thr:
        assert (cnt > p.max_faces_id).any()
        assert torch.equal(thr, b_thr)
        bad = (thr - thr_w).abs() > 1e-6 * thr_w.abs()
        assert bad.float().mean().item() <= THR_FRAC
    mostly_close(img, b_img, 1e-4)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag, b_ag) and torch.equal(img[:, :3], b_img[:, :3])
    gen = torch.Generator(device='cuda').manual_seed(5)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    grows = pxf_impl.launch_pxf_bwd(pin, img, ag, thr, g, p)
    gf, gt = tiled.face_sum(pin, grows, p)
    gf2, gt2 = pxf_impl.backward(pin, img, ag, thr, g, p)
    torch.cuda.synchronize()
    assert torch.equal(gf, gf2) and torch.equal(gt, gt2)
    sf_, st_ = tiled.sum_plain(pin, grows, p)
    grad_close(gf, sf_, frac=0.0)
    grad_close(gt, st_, frac=0.0)
    wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, thr_w, g, p)
    xf, xt = plain64(x, t, g, p, with_thr)
    kf, kt = cuda_impl.soft_rasterize_bwd(x, t, b_img, b_ag, b_thr, g, p, inputs)
    if not vertex:
        gt, wt, xt, kt = fold_ties(gt), fold_ties(wt), fold_ties(xt), fold_ties(kt)
    for got, want_, exact, binned in ((gf, wf, xf, kf), (gt, wt, xt, kt)):
        grad_close_or_knife_edge(got, want_, exact, binned)
    assert gf[:, :2].abs().amax() > 0 or p.dist_func == 'hard'   # the screen-filling faces


@pytest.mark.gpu
@pytest.mark.parametrize('K', [4, 40])
def test_softras_pxf_bands_reassemble_the_image(K):
    """Four contiguous bands of tile rows at 128 px: the bands' images,
    counts and thresholds side by side equal the whole image's, and their
    gradients summed equal the whole gradient."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxf_impl
    x, t = soup(12, F=500, T=4, radius=(0.05, 0.5))
    x = with_big_faces(x)
    t = tie_symmetric(t)
    p = make_params(image_size=128, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=K)
    whole = pxf_impl.prep_pxf(x, t, p, for_grad=True)
    img, ag, cnt, thr = pxf_impl.launch_pxf_fwd(whole, p, True)
    gen = torch.Generator(device='cuda').manual_seed(6)
    g = torch.randn(img.shape, generator=gen, device='cuda')
    gf, gt = pxf_impl.backward(whole, img, ag, thr, g, p)
    rows = whole.tiles_y // 4
    parts, sf, st = [], torch.zeros_like(gf), torch.zeros_like(gt)
    for k in range(4):
        pin = pxf_impl.prep_pxf(x, t, p, ty0=k * rows, ty_band=rows, for_grad=True)
        out = pxf_impl.launch_pxf_fwd(pin, p, True)
        parts.append(out)
        sl = slice(k * rows * whole.tile_h, (k + 1) * rows * whole.tile_h)
        bf, bt = pxf_impl.backward(pin, out[0], out[1], out[3], g[:, :, sl].contiguous(), p)
        sf += bf
        st += bt
    torch.cuda.synchronize()
    for i, full in enumerate((img, ag, cnt, thr)):
        assert torch.equal(torch.cat([o[i] for o in parts], dim=-2), full)
    grad_close(sf, gf, frac=0.0)
    grad_close(fold_ties(st), fold_ties(gt), frac=0.0)


@pytest.mark.gpu
def test_soft_rasterize_fpx_pxf_routes_on_the_card(monkeypatch):
    """Under JR_LAYOUT=f_px a frame launches K3 once and a grad_mode='full'
    step K3, K4 and the face sum once; a binding step takes the binned
    route.  Under JR_LAYOUT=px_f a step launches K5, K6 and the face sum
    once.  With JR_LAYOUT unset neither route runs."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.segment_sum import launch_segment_sum
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl, soft_rasterize
    wrappers = (cuda_impl.launch, cuda_impl.launch_thr, cuda_impl.launch_bwd,
                cuda_impl.launch_reduce, fpx_impl.launch_fpx_fwd, fpx_impl.launch_fpx_bwd,
                pxf_impl.launch_pxf_fwd, pxf_impl.launch_pxf_bwd, launch_segment_sum)
    x, t = soup(13, F=600, T=4, radius=(0.3, 0.6))
    x.requires_grad_(True)
    t.requires_grad_(True)

    def counts():
        return [w.launches for w in wrappers]

    def delta(step):
        before = counts()
        step()
        torch.cuda.synchronize()
        return [a - b for a, b in zip(counts(), before)]

    def frame():
        with torch.no_grad():
            soft_rasterize(x, t, image_size=64, sigma_val=1e-3)

    def step(**kw):
        return lambda: soft_rasterize(x, t, image_size=64, sigma_val=1e-3,
                                      **kw).sum().backward()

    monkeypatch.setenv('JR_LAYOUT', 'f_px')
    assert delta(frame) == [0] * 4 + [1, 0] + [0, 0] + [0]
    assert delta(step(grad_mode='full')) == [0] * 4 + [1, 1] + [0, 0] + [1]
    assert delta(step()) == [1, 1, 1, 1] + [0] * 5               # K = 16 < F binds
    monkeypatch.setenv('JR_LAYOUT', 'px_f')
    assert delta(frame) == [0] * 6 + [1, 0] + [0]
    assert delta(step()) == [0] * 6 + [1, 1] + [1]
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    monkeypatch.delenv('JR_LAYOUT')
    assert delta(step()) == [1, 1, 1, 1] + [0] * 5


@pytest.mark.gpu
def test_softras_fpx_pxf_wrappers_check_their_inputs():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl, tiled
    x, t = soup(1, F=40)
    p = make_params(image_size=32, max_faces_per_pixel_for_grad=1)
    pf = fpx_impl.prep_fpx(x, t, p, for_grad=True)
    pp = pxf_impl.prep_pxf(x, t, p, for_grad=True)
    img, ag, cnt, _ = fpx_impl.launch_fpx_fwd(pf, p)
    g = torch.ones_like(img)
    with pytest.raises(TypeError):
        fpx_impl.launch_fpx_fwd(pf._replace(rows=pf.rows.double()), p)
    with pytest.raises(ValueError):
        fpx_impl.launch_fpx_fwd(pf._replace(rows=pf.rows.cpu()), p)
    with pytest.raises(TypeError):
        pxf_impl.launch_pxf_fwd(pp._replace(entries=pp.entries.long()), p, True)
    with pytest.raises(ValueError):
        pxf_impl.launch_pxf_fwd(pp._replace(tile_off=pp.tile_off[:-1]), p, True)
    with pytest.raises(ValueError):
        fpx_impl.forward(pf, p, True)                     # f_px has no threshold
    with pytest.raises(ValueError):
        fpx_impl.launch_fpx_fwd(pf, p, True)
    with pytest.raises(ValueError):
        fpx_impl.launch_fpx_bwd(pf, img, ag, None, g[:, :3], p)
    with pytest.raises(ValueError):
        fpx_impl.launch_fpx_bwd(pf, img, ag, cnt.float(), g, p)
    with pytest.raises(ValueError):
        fpx_impl.backward(pf, img, ag, cnt.float(), g, p)  # untruncated
    img2, ag2, cnt2, thr2 = pxf_impl.launch_pxf_fwd(pp, p, True)
    with pytest.raises(ValueError):
        pxf_impl.launch_pxf_bwd(pp, img2, ag2, thr2[:, :5], g, p)
    rows = pxf_impl.launch_pxf_bwd(pp, img2, ag2, thr2, g, p)
    with pytest.raises(ValueError):
        tiled.face_sum(pp._replace(face_off=None), rows, p)
    with pytest.raises(ValueError):
        tiled.face_sum(pp, rows[:, :5], p)
    with pytest.raises(ValueError):
        pxf_impl.prep_pxf(x, t, make_params(image_size=20))
    with pytest.raises(ValueError):
        fpx_impl.prep_fpx(x, t, make_params(image_size=144))


# ---- fixed-order sums (ops/segment_sum.py): vertex normals and N3MR's depth
# gradient add per vertex or face in a fixed order, with no float atomics ----


@pytest.mark.gpu
def test_vertex_normals_bit_equal_twice_with_gradient():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops import segment_sum
    from jrender_tpu_torch.structures import vertex_normals_fn
    from jrender_tpu_torch.utils.primitives import uv_sphere
    v, f = uv_sphere(40, 50)
    rng = np.random.RandomState(3)
    v = torch.tensor(v[None].repeat(2, 0) * rng.uniform(0.9, 1.1, (2, 1, 1)), device='cuda',
                     dtype=torch.float32)
    f = torch.tensor(f[None].repeat(2, 0), device='cuda')
    g = torch.tensor(rng.randn(*v.shape), device='cuda', dtype=torch.float32)
    runs = []
    for _ in range(2):
        x = v.clone().requires_grad_(True)
        before = segment_sum.launch_segment_sum.launches
        n = vertex_normals_fn(x, f)
        (n * g).sum().backward()
        torch.cuda.synchronize()
        assert segment_sum.launch_segment_sum.launches == before + 1
        runs.append((n, x.grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    xc = v.cpu().requires_grad_(True)
    nc = vertex_normals_fn(xc, f.cpu())
    (nc * g.cpu()).sum().backward()
    assert torch.allclose(runs[0][0].cpu(), nc, rtol=1e-5, atol=1e-5)
    assert torch.allclose(runs[0][1].cpu(), xc.grad, rtol=1e-4, atol=1e-4 * xc.grad.abs().max())


@pytest.mark.gpu
def test_n3mr_depth_gradient_bit_equal_twice():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as ntorch
    from jrender_tpu_torch.ops.segment_sum import launch_segment_sum
    face = n3mr_soup(4, F=200, B=2)
    tex = n3mr_textures(2, 2, 200, 2)
    rows, fi, wt, dp, finv, zc, rgb = ncuda.forward_maps(face, tex, 64, 0.1, 100.0, 1e-3)
    gd = torch.tensor(np.random.RandomState(3).randn(*dp.shape).astype(np.float32),
                      device='cuda')
    before = launch_segment_sum.launches
    a = ntorch.backward_depth(face, fi, finv, wt, dp, zc, gd)
    b = ntorch.backward_depth(face, fi, finv, wt, dp, zc, gd)
    torch.cuda.synchronize()
    assert launch_segment_sum.launches == before + 2
    assert torch.equal(a, b) and a.abs().max() > 0
    c = ntorch.backward_depth(*(x.cpu() for x in (face, fi, finv, wt, dp, zc, gd)))
    assert torch.allclose(a.cpu(), c, rtol=1e-5, atol=1e-6 * c.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize('C', [1, 3, 9, 84])
def test_segment_sum_kernel_any_width(C):
    """The segment-sum kernel on rows of C values: empty segments are zero,
    rows past the segment count are dropped, the sums equal the plain
    version's within float32 reordering and two runs give the same bits;
    it refuses CPU rows, other dtypes and an order of another length."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops import segment_sum as ss
    rng = np.random.RandomState(C)
    seg = rng.randint(0, 600, size=5000)
    seg = np.where((seg >= 500) & (seg < 520), seg + 80, seg)   # 500-519 empty, 520-599 dropped
    seg = torch.tensor(seg, device='cuda')
    rows = torch.tensor(rng.randn(5000, C).astype(np.float32), device='cuda')
    so = ss.segment_order(seg, 520)
    a = ss.launch_segment_sum(rows, so)
    b = ss.launch_segment_sum(rows, so)
    torch.cuda.synchronize()
    assert a.shape == (520, C) and torch.equal(a, b)
    assert not a[500:].any()
    want = ss.sum_plain(rows.cpu(), ss.SegmentOrder(None, so.off.cpu(), so.order.cpu(), 520))
    assert torch.allclose(a.cpu(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ss.launch_segment_sum(rows.cpu(), so)
    with pytest.raises(TypeError):
        ss.launch_segment_sum(rows.double(), so)
    with pytest.raises(ValueError):
        ss.launch_segment_sum(rows[:-1], so)
