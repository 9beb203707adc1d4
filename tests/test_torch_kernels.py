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


def soup(seed, F, B=1, T=25, radius=(0.03, 0.3), centre=(-0.8, 0.8)):
    """Random well-shaped triangles in front of the camera."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(*centre, (B, F, 1, 2))
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
@pytest.mark.parametrize('T', [1, 4, 9, 25])
def test_softras_bwd_reduce_kernel_matches_plain(T):
    """The face reduction on the backward's slot rows, at T = 1 (12 columns:
    four lanes a face, eight faces a warp), 4 (21: scalar columns), 9 (36:
    float4 columns, 16 lanes a face, two faces a warp) and 25 (84: float4
    columns, a warp a face), with big faces and B = 2: its plain version adds
    each face's rows in the kernel's order, so the two agree bit for bit;
    twice, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(7, F=300, B=2, T=T)
    x = with_big_faces(x)
    p = make_params(image_size=72, sigma_val=1e-3, gamma_val=1e-3)
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    inputs = inputs._replace(lists=binning.build_tile_lists_compact(
        x, 72, cuda_impl.TILE, cuda_impl.TILE, p.threshold, 6, with_inverse=True))
    assert int(inputs.lists.gcount.min()) >= 2
    img, ag, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.topk_threshold(x, p, inputs, counts)
    g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(8),
                    device='cuda')
    rows = cuda_impl.launch_bwd(inputs, img, ag, thr, g, p)
    got = cuda_impl.launch_reduce(inputs, rows, p)
    again = cuda_impl.launch_reduce(inputs, rows, p)
    want = cuda_impl.reduce_rows_plain(inputs, rows, p)
    torch.cuda.synchronize()
    assert rows.gslots.shape[2] == 9 + 3 * T
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, w)
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0


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


# ---- the split of a tile's list over blocks (K1: a cluster, K2: ranks) ---------
#
# The binned forward splits each tile's sequence of faces (big faces, then
# its run) over a cluster of cuda_impl.FWD_SPLIT blocks and merges their
# partial states in rank order; the binned backward splits each tile's run
# over cuda_impl.BWD_SPLIT blocks.  Counts and hard winners are held to the
# plain version exactly, images at the forward tolerance, gradients at the
# backward's; every output is bit-equal twice.

def dense_soup(seed, F, B=1, T=4):
    """Small faces crowded into the middle of the screen: at 128 px the
    busiest tile's list holds over a thousand faces, many chunks per rank."""
    return soup(seed, F=F, B=B, T=T, radius=(0.02, 0.08), centre=(-0.3, 0.3))


def lists_with_cap(x, p, mt, for_grad=False):
    """The binning with an emit cap of ``mt`` tiles: wider faces go to the
    big-face list."""
    return binning.build_tile_lists_compact(x, p.image_size, cuda_impl.TILE, cuda_impl.TILE,
                                            p.threshold, mt, with_inverse=for_grad)


def fwd_split_check(x, t, p, mt=None, ranks_busy=True):
    """The forward kernel twice and against the plain version; returns its
    outputs and the inputs."""
    inputs = cuda_impl.prepare(x, t, p)
    if mt is not None:
        inputs = inputs._replace(lists=lists_with_cap(x, p, mt))
    cl = inputs.lists
    longest = int(cl.gcount.max()) + int(cl.run_counts.max())
    if ranks_busy:
        # every rank of the busiest tile walks more than one chunk
        chunk = cuda_impl.staged_chunk(inputs.rows.shape[-1])
        assert longest > cuda_impl.FWD_SPLIT * chunk, longest
    out = cuda_impl.launch(inputs, p)
    again = cuda_impl.launch(inputs, p)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    img, ag, cnt = out
    want, ag_w, cnt_w = torch_impl.soft_rasterize_fwd_plain(x, t, p)
    mostly_close(img[:, :3], want[:, :3], 1e-4)
    mostly_close(img[:, 3], want[:, 3], 1e-4)
    assert torch.equal(cnt, cnt_w)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag[:, 1], ag_w[:, 1])          # the winners' ids
        mostly_close(ag[:, 0], ag_w[:, 0], 1e-4)
    return out, inputs


@pytest.mark.gpu
@pytest.mark.parametrize('alpha', ['hard', 'sum', 'prod'])
@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
@pytest.mark.parametrize('dist', ['hard', 'barycentric', 'euclidean'])
def test_softras_fwd_split_long_lists(dist, rgb, alpha):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(11, F=3000)
    fwd_split_check(x, t, make_params(image_size=128, dist_func=dist, aggr_func_rgb=rgb,
                                      aggr_func_alpha=alpha, sigma_val=1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_softras_fwd_split_rank_zero_alone(rgb):
    """A sparse soup: most tiles' lists hold one face or none, which rank 0
    walks and writes without a merge."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(12, F=24, B=2, radius=(0.01, 0.03))
    _, inputs = fwd_split_check(x, t, make_params(image_size=128, aggr_func_rgb=rgb),
                                ranks_busy=False)
    runs = inputs.lists.run_counts
    assert int(inputs.lists.gcount.max()) == 0 and ((runs == 1).sum() > (runs > 1).sum())


@pytest.mark.gpu
@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_softras_fwd_split_big_faces_cross_ranks(rgb):
    """An emit cap of 2 tiles: most faces are big, and the big-face prefix
    of a tile's sequence spans several ranks' shares (a big face whose tile
    range misses the tile is skipped by whichever rank holds it)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(13, F=3000)
    p = make_params(image_size=128, aggr_func_rgb=rgb, sigma_val=1e-4)
    _, inputs = fwd_split_check(x, t, p, mt=2)
    cl = inputs.lists
    per = -(-(int(cl.gcount.max()) + int(cl.run_counts.max())) // cuda_impl.FWD_SPLIT)
    assert int(cl.gcount.max()) > 2 * per


@pytest.mark.gpu
@pytest.mark.parametrize('mt', [None, 2])
def test_softras_fwd_split_ties_go_to_the_lowest_id(mt):
    """Faces F..2F-1 repeat faces 0..F-1 with other colours, so every pixel
    a face wins ties it with its twin at the same depth; the twins lie in
    different ranks' shares of the long sequences, as run faces or (emit cap
    2) big faces.  The winner must be the lower id."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(14, F=1500)
    x2, t2 = torch.cat([x, x], dim=1), torch.cat([t, t.flip(-1)], dim=1)
    p = make_params(image_size=128, aggr_func_rgb='hard', sigma_val=1e-4)
    (img, ag, _), _ = fwd_split_check(x2, t2, p, mt=mt)
    won = ag[:, 1]
    assert (won >= 0).sum() > 1000 and not (won >= 1500).any()


@pytest.mark.gpu
def test_softras_fwd_split_variants_agree():
    """The forward built with 1 and 8 blocks per tile against the default
    build: the same counts and winners, sums within rounding."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(15, F=3000)
    for rgb in ('hard', 'softmax'):
        p = make_params(image_size=128, aggr_func_rgb=rgb, sigma_val=1e-4)
        inputs = cuda_impl.prepare(x, t, p)
        img, ag, cnt = cuda_impl.launch(inputs, p)
        for split in (1, 8):
            args, (img_v, ag_v, cnt_v) = cuda_impl.fwd_args(inputs, p)
            cuda_impl._run(cuda_impl.split_variant('softras_fwd', split), 'softras_fwd', args,
                           x.device)
            torch.cuda.synchronize()
            assert torch.equal(cnt, cnt_v)
            torch.testing.assert_close(img_v, img, atol=1e-5, rtol=0)
            if rgb == 'hard':
                assert torch.equal(ag, ag_v)


def thr_split_check(x, t, p, mt=None):
    """The threshold kernel twice (bit-equal) and against the plain
    version, on the forward kernel's counts; returns (thr, counts, inputs)."""
    inputs = cuda_impl.prepare(x, t, p)
    if mt is not None:
        inputs = inputs._replace(lists=lists_with_cap(x, p, mt))
    _, _, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.launch_thr(inputs, counts, p)
    again = cuda_impl.launch_thr(inputs, counts, p)
    torch.cuda.synchronize()
    assert torch.equal(thr, again)
    K = p.max_faces_id
    assert (counts > K).any()
    want = torch_impl.topk_threshold_plain(x, p)
    bad = (thr - want).abs() > 1e-6 * want.abs()
    assert bad.float().mean().item() <= THR_FRAC, bad.float().mean().item()
    assert (thr[counts <= K] == p.far).all()
    return thr, counts, inputs


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 4, 16, 40])
@pytest.mark.parametrize('dist', ['hard', 'barycentric', 'euclidean'])
def test_softras_thr_split_long_lists(dist, K):
    """Lists of many chunks for each of the cluster's ranks; K = 40 takes
    the bisection, whose counts are summed across the ranks."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(16, F=3000, T=1)
    _, _, inputs = thr_split_check(x, t, make_params(
        image_size=128, dist_func=dist, sigma_val=1e-4, max_faces_per_pixel_for_grad=K))
    cl = inputs.lists
    assert int(cl.gcount.max()) + int(cl.run_counts.max()) > \
        cuda_impl.FWD_SPLIT * cuda_impl.thr_chunk(K)


@pytest.mark.gpu
@pytest.mark.parametrize('K', [4, 40])
def test_softras_thr_split_big_faces_cross_ranks(K):
    """An emit cap of 2 tiles: the big-face prefix of a tile's sequence
    spans several ranks' shares."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(17, F=3000, T=1)
    p = make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=K)
    _, _, inputs = thr_split_check(x, t, p, mt=2)
    cl = inputs.lists
    per = -(-(int(cl.gcount.max()) + int(cl.run_counts.max())) // cuda_impl.FWD_SPLIT)
    assert int(cl.gcount.max()) > 2 * per


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 2, 3])
def test_softras_thr_split_twins_keep_multiplicity(K):
    """Faces F..2F-1 repeat faces 0..F-1: each depth comes twice, from
    shares of different ranks, and counts twice towards K."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(18, F=1500, T=1)
    x2, t2 = torch.cat([x, x], dim=1), torch.cat([t, t], dim=1)
    p = make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=K)
    thr, counts, _ = thr_split_check(x2, t2, p)
    p1 = make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=(K + 1) // 2)
    once = cuda_impl.prepare(x, t, p1)
    _, _, c1 = cuda_impl.launch(once, p1)
    thr1 = cuda_impl.launch_thr(once, c1, p1)
    # the K-th smallest of every depth twice is the ceil(K/2)-th of each once
    both = (counts > K) & (c1 > (K + 1) // 2)
    assert both.any() and torch.equal(thr[both], thr1[both])


@pytest.mark.gpu
def test_softras_thr_split_lone_faces():
    """A sparse soup: most tiles' lists hold one face or none; the tiles
    with no pixel over K leave at once, every rank alike."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(12, F=60, B=2, radius=(0.01, 0.2))
    thr_split_check(x, t, make_params(image_size=128, max_faces_per_pixel_for_grad=1))


@pytest.mark.gpu
@pytest.mark.parametrize('K', [16, 40])
def test_softras_thr_split_variants_agree(K):
    """The threshold built with 1, 2 and 4 blocks per tile against the
    default build: the same map, bit for bit (the merge is exact)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = dense_soup(19, F=3000, T=1)
    p = make_params(image_size=128, sigma_val=1e-4, max_faces_per_pixel_for_grad=K)
    inputs = cuda_impl.prepare(x, t, p)
    _, _, counts = cuda_impl.launch(inputs, p)
    thr = cuda_impl.launch_thr(inputs, counts, p)
    for split in (1, 2, 4):
        args, thr_v = cuda_impl.thr_args(inputs, counts, p)
        cuda_impl._run(cuda_impl.split_variant('softras_thr', split), 'softras_thr', args,
                       x.device)
        torch.cuda.synchronize()
        assert torch.equal(thr, thr_v), split


@pytest.mark.gpu
@pytest.mark.parametrize('T', [324, 2500])
def test_softras_split_kernels_rows_past_48_kb(T):
    """Many texels a face: at 18 x 18 the backward's two staged chunks and
    its texel sums pass 48 KB of shared memory, at 50 x 50 the forward's
    two chunks of one face do (and the backward's texel sums pass a block's
    most, which its wrapper refuses); the kernels ask the card for what
    they need."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(17, F=60, T=T)
    t = tie_symmetric(t)
    p = make_params(image_size=64, sigma_val=1e-3, gamma_val=1e-3)
    row = cuda_impl.ROW_BASE + 3 * T
    reserved = cuda_impl.bwd_reserved_bytes(3 * T)
    (img, ag, counts), _ = fwd_split_check(x, t, p, ranks_busy=False)
    inputs = cuda_impl.prepare(x, t, p, for_grad=True)
    thr = cuda_impl.topk_threshold(x, p, inputs, counts)
    g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(7),
                    device='cuda')
    if T == 2500:
        assert 8 * cuda_impl.staged_chunk(row) * (row + 1) > cuda_impl.SMEM_BYTES
        with pytest.raises(ValueError):
            cuda_impl.soft_rasterize_bwd(x, t, img, ag, thr, g, p, inputs)
        return
    assert 8 * cuda_impl.staged_chunk(row, reserved) * (row + 1) + reserved > cuda_impl.SMEM_BYTES
    gf, gt = cuda_impl.soft_rasterize_bwd(x, t, img, ag, thr, g, p, inputs)
    wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag,
                                                 torch_impl.topk_threshold_plain(x, p), g, p)
    grad_close(gf, wf)
    grad_close(fold_ties(gt), fold_ties(wt))


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(dist_func='barycentric', aggr_func_alpha='sum'),
    dict(dist_func='hard', aggr_func_rgb='hard', aggr_func_alpha='hard'),
    dict(texture_type='vertex', gamma_val=0.1),
    dict(grad_mode='full'),
], ids=['default', 'bary-sum', 'hard', 'vertex', 'full'])
def test_softras_bwd_split_long_runs(kw):
    """Runs of over a thousand faces, many chunks per rank, and with an emit
    cap of 2 tiles most faces big: against the plain version, bit-equal
    twice, and the slot rows bit-equal to those of the backward built with
    one block and with 8 blocks per tile (a row is one warp's walk,
    whichever block)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    vertex = kw.get('texture_type') == 'vertex'
    x, t = dense_soup(16, F=3000, T=3 if vertex else 4)
    t = t.reshape(1, 3000, 3, 3) if vertex else tie_symmetric(t)
    p = make_params(image_size=128, **{'sigma_val': 1e-4, 'gamma_val': 1e-3, **kw})
    for mt in (None, 2):
        inputs = cuda_impl.prepare(x, t, p, for_grad=True)
        if mt is not None:
            inputs = inputs._replace(lists=lists_with_cap(x, p, mt, for_grad=True))
        cl = inputs.lists
        GC = 9 + (9 if vertex else 3 * 4)
        chunk = cuda_impl.staged_chunk(inputs.rows.shape[-1],
                                       cuda_impl.bwd_reserved_bytes(0 if vertex else GC - 9))
        if mt is None:
            assert int(cl.run_counts.max()) > cuda_impl.BWD_SPLIT * chunk
        else:
            assert int(cl.gcount.max()) > 1000
        img, ag, counts = cuda_impl.launch(inputs, p)
        thr = cuda_impl.topk_threshold(x, p, inputs, counts)
        g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(6),
                        device='cuda')
        rows = cuda_impl.launch_bwd(inputs, img, ag, thr, g, p)
        gf, gt = cuda_impl.launch_reduce(inputs, rows, p)
        gf2, gt2 = cuda_impl.soft_rasterize_bwd(x, t, img, ag, thr, g, p, inputs)
        torch.cuda.synchronize()
        assert torch.equal(gf, gf2) and torch.equal(gt, gt2.reshape(gt.shape))
        n = int(cl.run_counts.sum())                      # the rows the runs fill
        for split in (1, 8):
            args, rows_v = cuda_impl.bwd_args(inputs, img, ag, thr, g, p)
            cuda_impl._run(cuda_impl.split_variant('softras_bwd', split), 'softras_bwd', args,
                           x.device)
            torch.cuda.synchronize()
            assert torch.equal(rows.gslots[:, :n], rows_v.gslots[:, :n])
        thr_plain = None if thr is None else torch_impl.topk_threshold_plain(x, p)
        wf, wt = torch_impl.soft_rasterize_bwd_plain(x, t, img, ag, thr_plain, g, p)
        wt = wt.reshape(gt.shape)
        if not vertex:
            gt, wt = fold_ties(gt), fold_ties(wt)
        grad_close(gf, wf)
        grad_close(gt, wt)


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
    # every build of MAPS_BUILDS (1 to 8 tiles a cluster), twice: the
    # default build's maps, bit for bit; and on the last tile's cluster
    # alone (past the image at 72 px), its tiles' maps
    from jrender_tpu_torch import _build
    _build.build([('n3mr_maps', ncuda.maps_defines(b)) for b in ncuda.MAPS_BUILDS])
    lists = ncuda.tile_lists(face, is_)
    tiles = -(-is_ // ncuda.TILE)
    for b in ncuda.MAPS_BUILDS:
        defines = ncuda.maps_defines(b)
        for _ in range(2):
            args, out = ncuda.maps_args(rows, lists, tex, is_, 0.1, 100.0, 1e-3)
            cuda_impl._run(ncuda.maps_variant(defines), 'n3mr_maps', args, rows.device)
            torch.cuda.synchronize()
            assert all((x is None and y is None) or torch.equal(x, y)
                       for x, y in zip(out, got)), b
        args, out = ncuda.maps_args(rows, lists, tex, is_, 0.1, 100.0, 1e-3,
                                    tile=tiles * tiles - 1)
        cuda_impl._run(ncuda.maps_variant(defines), 'n3mr_maps', args, rows.device)
        torch.cuda.synchronize()
        y0, x0 = (tiles - 1 - (tiles - 1) % int(b)) * ncuda.TILE, (tiles - 1) * ncuda.TILE
        assert all((x is None and y is None) or torch.equal(x[:, y0:, x0:], y[:, y0:, x0:])
                   for x, y in zip(out, got)), b
        assert ncuda.maps_occupancy(defines)['blocks_per_sm'] >= 1, b


@pytest.mark.gpu
@pytest.mark.parametrize('ts', [1, 2, 3, 4, 6, 7, 9])
def test_n3mr_texbwd_kernel_matches_plain(ts):
    """Texture sizes 1 to 4 take the register sums, 6 the shared ones in
    one walk, 7 and 9 several walks."""
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


def n3mr_edge_case(face, is_, rr, ra, seed=6):
    """The maps of ``face`` at ``is_`` px and seeded incoming gradients:
    the edge gradient's arguments."""
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    B, F = face.shape[:2]
    tex = n3mr_textures(seed, B, F, 2)
    rows, fi, wt, dp, finv, zc, rgb = ncuda.forward_maps(face, tex, is_, 0.1, 100.0, 1e-3)
    alpha = (fi >= 0).float()
    gen = torch.Generator(device='cuda').manual_seed(seed)
    gr = torch.randn(rgb.shape, generator=gen, device='cuda')
    ga = torch.randn(alpha.shape, generator=gen, device='cuda')
    return (face, fi, rgb, alpha, gr, ga, is_, 1e-3, rr, ra)


@pytest.mark.gpu
@pytest.mark.parametrize('is_', [64, 72, 130])
def test_n3mr_edge_bands_kernel_matches_plain(is_):
    """The band-key kernel's keys and items equal the plain version's, bit
    for bit, with a back face, a NaN corner, a zero-area face and a ragged
    last band."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
    from jrender_tpu_torch.utils.checks import n3mr_special_faces
    args = n3mr_edge_case(n3mr_special_faces(n3mr_soup(20, 150, B=2)), is_, True, True)
    pp = ncuda.edge_inputs(*args[:7], True, True)[0]
    keys, items = ncuda.launch_edge_bands(pp, is_)
    keys_w, items_w = ncuda.band_keys_plain(pp, is_)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_w) and torch.equal(items, items_w)
    nb = items[:, 2]
    assert (nb < 0).any() and (nb > 1).any() and (nb == 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize('rr,ra', [(True, True), (True, False), (False, True)])
def test_n3mr_edgebwd_long_edges_go_global(rr, ra):
    """Triangles over most of a 128-px screen: many edges span more than
    EDGE_SPAN bands and take the global list, the others the bands."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, scaled_err
    args = n3mr_edge_case(n3mr_soup(21, 60, B=2), 128, rr, ra)
    bands = ncuda.edge_bands(ncuda.edge_inputs(*args[:7], rr, ra)[0], 128)
    nb = bands.items[:, 2]
    assert (nb < 0).sum() > 10 and (nb > 0).sum() > 10
    got = ncuda.backward_pixel_map(*args)
    again = ncuda.backward_pixel_map(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert scaled_err(got, nplain.backward_pixel_map(*args)) <= N3MR_SUM_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('is_,rr,ra', [(1024, True, True), (2048, True, False)])
def test_n3mr_edgebwd_column_segments(is_, rr, ra):
    """Rows too wide for a band block's shared memory (rgb and alpha at
    1024 px, rgb at 2048 px, anti-aliasing's size): the blocks take column
    segments of the band."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, scaled_err
    nch = (2 if ra else 0) + (6 if rr else 0)
    assert ncuda.edge_segment_width(is_, nch) < is_
    args = n3mr_edge_case(n3mr_soup(22, 40, shrink=0.3), is_, rr, ra)
    got = ncuda.backward_pixel_map(*args)
    again = ncuda.backward_pixel_map(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert scaled_err(got, nplain.backward_pixel_map(*args)) <= N3MR_SUM_TOL


@pytest.mark.gpu
@pytest.mark.parametrize('band', [1, 2, 8])
def test_n3mr_edgebwd_band_variants_agree(band):
    """The edge kernels built with bands of 1, 2 and 8 rows against the
    plain version and the default build (their partial sums differ, so
    within the same tolerance, not bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda, torch_impl as nplain
    from jrender_tpu_torch.utils.checks import N3MR_SUM_TOL, scaled_err
    args = n3mr_edge_case(n3mr_soup(23, 120, B=2, shrink=0.5), 96, True, True)
    inputs = ncuda.edge_inputs(*args[:7], True, True)
    got = ncuda.edgebwd_variant(band)(*inputs, 1e-3, True, True)
    torch.cuda.synchronize()
    want = nplain.backward_pixel_map(*args)
    assert scaled_err(got, want) <= N3MR_SUM_TOL
    assert scaled_err(got, ncuda.backward_pixel_map(*args)) <= N3MR_SUM_TOL


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
    table = dir_impl.prep_dir(x, t, p, for_grad=True)     # the prep kernel's items
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
    # the backward needs the prep kernel's items, of this image size
    with pytest.raises(ValueError, match='for_grad'):
        dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
    other = dir_impl.prep_dir(x, t, make_params(image_size=64), for_grad=True)
    with pytest.raises(ValueError, match='for_grad'):
        dir_impl.launch_dir_bwd(other, img, ag, thr, g, p)


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(),
    dict(aggr_func_rgb='hard', max_faces_per_pixel_for_grad=4),
    dict(texture_type='vertex', grad_mode='full', gamma_val=0.1),
    dict(max_faces_per_pixel_for_grad=40),
], ids=['default-K16', 'hard-K4', 'vertex-full', 'K40'])
def test_softras_dir_builds_agree(kw):
    """K10 and K11 twice give the same outputs bit for bit (image,
    aggregates, counts, threshold; face and texture gradients), and K10
    gives them with its rows staged by the block and by warps with the
    cull, each twice, on 600 faces with two screen-filling ones over two
    batch elements at 128 px (splits 1) and 256 px (4 splits a face); the
    wrappers' outputs are held to the plain versions by
    ``test_softras_dir_kernels_match_plain_and_binned``."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    vertex = kw.get('texture_type') == 'vertex'
    x, t = soup(8, F=600, B=2, T=3 if vertex else 25, radius=(0.03, 0.3))
    x = with_big_faces(x)
    t = t.reshape(2, 600, 3, 3) if vertex else t
    fwd = cuda_impl._entry('softras_dir_fwd', 'softras_dir_fwd', dir_impl._DirFwdArgs)
    bwd = cuda_impl._entry('softras_dir_bwd', 'softras_dir_bwd', dir_impl._DirBwdArgs)
    for size in (128, 256):
        p = make_params(image_size=size, **{'sigma_val': 1e-3, 'gamma_val': 1e-3, **kw})
        with_thr = torch_impl.use_threshold(p, 600)
        table = dir_impl.prep_dir(x, t, p, for_grad=True)
        out = dir_impl.launch_dir_fwd(table, p, with_thr)
        again = dir_impl.launch_dir_fwd(table, p, with_thr)
        img, ag, cnt, thr = out
        gen = torch.Generator(device='cuda').manual_seed(size)
        g = torch.randn(img.shape, generator=gen, device='cuda')
        grads = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        grads2 = dir_impl.launch_dir_bwd(table, img, ag, thr, g, p)
        torch.cuda.synchronize()

        def same(got, want):
            return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))

        assert same(again, out) and same(grads2, grads)
        assert not with_thr or (cnt > p.max_faces_id).any()
        for warp_rows in (False, True, False, True):   # both ways of staging, twice
            args, got = dir_impl.fwd_args(table, p, with_thr, warp_rows)
            cuda_impl._run(fwd, 'softras_dir_fwd', args, x.device)
            torch.cuda.synchronize()
            assert same(got, out), (size, warp_rows)
            assert dir_impl.fwd_occupancy(args)['blocks_per_sm'] >= 1
        for _ in range(2):
            args, got = dir_impl.bwd_args(table, img, ag, thr, g, p)
            cuda_impl._run(bwd, 'softras_dir_bwd', args, x.device)
            torch.cuda.synchronize()
            assert same(got, grads), size
        assert dir_impl.bwd_occupancy(args)['blocks_per_sm'] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize('B,F,size', [(1, 288, 1024), (2, 700, 256), (3, 1300, 64), (1, 5, 32)])
def test_softras_dir_prep_matches_plain(B, F, size):
    """The prep kernel (csrc/softras_dir_prep.cu) against ``prep_plain`` to
    the bit, twice: the bboxes gathered by a permutation, the unions of
    every 256 places, the items' offsets and count and the zeroed
    counters; a NaN face and off-screen faces among them."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    gen = torch.Generator(device='cuda').manual_seed(F)
    lo = torch.rand((B, F, 2), generator=gen, device='cuda') * 2.6 - 1.3
    ext = torch.rand((B, F, 2), generator=gen, device='cuda') ** 4 * 2.0
    bbox = torch.stack([lo[..., 0], lo[..., 0] + ext[..., 0], lo[..., 1], lo[..., 1] + ext[..., 1]],
                       dim=-1).contiguous()
    bbox[0, F // 2, 1] = float('nan')
    ids = torch.stack([torch.randperm(F, generator=gen, device='cuda') for _ in range(B)]).int()
    want = dir_impl.prep_plain(bbox, ids, size, True)

    def bits(t):           # the NaN face's bbox compares by its bits
        return t.view(torch.int32)

    for _ in range(2):
        got = dir_impl.launch_dir_prep(bbox, ids, size, True)
        assert torch.equal(bits(got[0]), bits(want[0])) and torch.equal(got[1], want[1])
        for a, b in zip(got[2][:3], want[2][:3]):
            assert torch.equal(a, b)
        assert dir_impl.item_count(got[2]) == dir_impl.item_count(want[2]) > 0
    frame = dir_impl.launch_dir_prep(bbox, ids, size, False)
    assert torch.equal(bits(frame[0]), bits(want[0])) and torch.equal(frame[1], want[1])
    assert frame[2] is None


@pytest.mark.gpu
def test_softras_dir_preps_on_two_streams():
    """Preps launched on two streams at once share no state (the grid
    barrier is each launch's own): each, on a table of its own, equals
    ``prep_plain`` to the bit, five times over."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    gen = torch.Generator(device='cuda').manual_seed(17)
    cases = []
    for B, F, size in ((40, 3000, 64), (3, 20000, 1024)):
        lo = torch.rand((B, F, 2), generator=gen, device='cuda') * 2.6 - 1.3
        ext = torch.rand((B, F, 2), generator=gen, device='cuda') ** 4 * 2.0
        bbox = torch.stack([lo[..., 0], lo[..., 0] + ext[..., 0], lo[..., 1],
                            lo[..., 1] + ext[..., 1]], dim=-1).contiguous()
        ids = torch.stack([torch.randperm(F, generator=gen, device='cuda')
                           for _ in range(B)]).int()
        cases.append((bbox, ids, size, dir_impl.prep_plain(bbox, ids, size, True)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(5):
        got = []
        for (bbox, ids, size, _), st in zip(cases, streams):
            with torch.cuda.stream(st):
                got.append(dir_impl.launch_dir_prep(bbox, ids, size, True))
        torch.cuda.synchronize()
        for (_, _, _, want), g in zip(cases, got):
            assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
            for a, b in zip(g[2][:3], want[2][:3]):
                assert torch.equal(a, b)
            assert dir_impl.item_count(g[2]) == dir_impl.item_count(want[2]) > 0


@pytest.mark.gpu
def test_softras_dir_bwd_runs_on_the_live_items():
    """K11's work items on the card are the plain rule's (offsets and count),
    its partial rows one an item; the forward after a prep with the items
    reads nothing to the host (``set_sync_debug_mode('error')``), and the
    backward's wait on the count is timed."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import dir_impl
    x, t = soup(9, F=300, B=2, T=4)
    x = with_big_faces(x)
    x[0, 5, 1] = float('nan')
    x[1, 6, 0::3] = 5.0                                   # off the screen
    p = make_params(image_size=256, sigma_val=1e-3)
    dir_impl.launch_dir_fwd(dir_impl.prep_dir(x, t, p, for_grad=True), p, True)   # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        table = dir_impl.prep_dir(x, t, p, for_grad=True)
        img, ag, cnt, thr = dir_impl.launch_dir_fwd(table, p, True)
        frame = dir_impl.launch_dir_fwd(dir_impl.prep_dir(x, t, p), p, False)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert torch.equal(frame[0], dir_impl.launch_dir_fwd(table, p, False)[0])
    face, split = dir_impl.bwd_items_plain(table.bbox.cpu(), 256)
    n = np.bincount(face.numpy(), minlength=2 * 300)
    assert dir_impl.item_count(table.items) == face.numel() == int(n.sum())
    np.testing.assert_array_equal(dir_impl.item_offsets(table.items, 2, 300).cpu().numpy(),
                                  np.concatenate([[0], np.cumsum(n)]))
    assert table.items.splits == 4 and n.max() == 4 and (n == 0).sum() >= 2
    args, (gf, gt) = dir_impl.bwd_args(table, img, ag, thr, torch.ones_like(img), p)
    assert args.items == face.numel() and args.keep[1].shape == (face.numel(), 9 + 12)
    gf2, gt2 = dir_impl.launch_dir_bwd(table, img, ag, thr, torch.ones_like(img), p)
    torch.cuda.synchronize()
    assert dir_impl.launch_dir_bwd.wait_ms >= 0.0
    assert torch.isfinite(gf2[0, torch.arange(300, device='cuda') != 5]).all()
    assert (gf2[1, 6] == 0).all() and (gt2[1, 6] == 0).all()     # no item: a zero row


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


# K3 and K5 split each tile's list over a cluster of tiled.TILE_SPLIT blocks
# and merge the ranks' states in rank order (csrc/softras_tile_fwd.cuh).  They
# are held to the plain version of that split (tiled.fwd_split_plain): counts,
# hard winners and thresholds exactly, images at the forward tolerance; and to
# the builds with 2 and 4 blocks a tile: counts, winners and thresholds bit for
# bit, images within 1e-5 (the shares are rescaled and added in another order).


def tile_split_inputs(route, case, rgb, K):
    """The route's inputs at 128 px for one case of the split: 'long' (a
    dense soup: the busiest tile's list is several chunks a rank), 'big'
    (emit cap 2: the big-face prefix of a list spans ranks), 'twins' (faces
    F..2F-1 repeat faces 0..F-1: depth ties across ranks go to the lower
    id, and each depth counts twice towards K), 'lone' (most lists hold one
    face or none)."""
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl, tiled
    if case == 'lone':
        # two small faces far apart: one tile row of each holds them
        x = torch.tensor([[[c - 0.05, c - 0.05, 2.5, c + 0.05, c - 0.05, 2.4, c, c + 0.05, 2.6]
                           for c in (-0.75, 0.75)]], device='cuda')
        t = torch.rand((1, 2, 4, 3), generator=torch.Generator(device='cuda').manual_seed(21),
                       device='cuda')
    else:
        x, t = dense_soup(20, F=1500 if case == 'twins' else 3000, T=4)
        if case == 'twins':
            x, t = torch.cat([x, x], dim=1), torch.cat([t, t.flip(-1)], dim=1)
    kw = dict(image_size=128, aggr_func_rgb=rgb, sigma_val=1e-4)
    if route == 'fpx':
        p = make_params(grad_mode='full', **kw)
        th, tw, group = *fpx_impl.tile_shape(128), fpx_impl.GROUP
    else:
        p = make_params(max_faces_per_pixel_for_grad=K, **kw)
        th = tw = pxf_impl.tile_for(128)
        group = pxf_impl.GROUP
    pin = tiled.prep(x, t, p, th, tw, group)
    if case == 'big':
        B, F = x.shape[:2]
        lists = binning.build_tile_lists_compact(x, 128, th, tw, p.threshold, 2)
        pin = pin._replace(**tiled.tile_work(lists, B, F, pin.tiles_y, pin.tiles_x, group)._asdict())
    return x, t, p, pin


def tile_split_launch(route, pin, p):
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl
    if route == 'fpx':
        return fpx_impl.launch_fpx_fwd(pin, p)
    return pxf_impl.launch_pxf_fwd(pin, p, True)


@pytest.mark.gpu
@pytest.mark.parametrize('case,rgb,K', [
    ('long', 'softmax', 16), ('long', 'hard', 40), ('big', 'softmax', 16), ('big', 'hard', 4),
    ('twins', 'hard', 3), ('lone', 'softmax', 1)])
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_softras_tile_fwd_split_matches_split_plain(route, case, rgb, K):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import tiled
    x, t, p, pin = tile_split_inputs(route, case, rgb, K)
    sizes = pin.tile_off[1:] - pin.tile_off[:-1]
    if case == 'lone':
        assert int(sizes.max()) == 1 and (sizes == 0).any()
    else:
        # every rank of the busiest tile walks more than one chunk
        chunk = tiled.fwd_chunk(pin.rows.shape[-1], tiled.fwd_threads(pin.tile_h, pin.tile_w),
                                tiled.fwd_own_bytes(p, route == 'pxf'))
        assert int(sizes.max()) > tiled.TILE_SPLIT * chunk
    out = tile_split_launch(route, pin, p)
    again = tile_split_launch(route, pin, p)
    torch.cuda.synchronize()
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(out, again))
    img, ag, cnt, thr = out
    with_thr = route == 'pxf'
    want, ag_w, cnt_w, thr_w = tiled.fwd_split_plain(pin, p, with_thr)
    assert torch.equal(cnt, cnt_w)
    mostly_close(img, want, 1e-4)
    if rgb == 'hard':
        assert torch.equal(ag[:, 1], ag_w[:, 1])          # the winners' ids
        mostly_close(ag[:, 0], ag_w[:, 0], 1e-4)
    if with_thr:
        assert (cnt > K).any() or case == 'lone'
        bad = (thr - thr_w).abs() > 1e-6 * thr_w.abs()
        assert bad.float().mean().item() <= THR_FRAC
        assert (thr[cnt <= K] == p.far).all()
    if case == 'twins':
        won = ag[:, 1]
        assert (won >= 0).sum() > 1000 and not (won >= 1500).any()
    # the unsplit plain version: the same counts
    assert torch.equal(cnt, tiled.fwd_plain(pin, p, with_thr)[2])


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_softras_tile_fwd_split_variants_agree(route):
    """K3 and K5 built with 2 and 4 blocks per tile against the default
    build: counts, winners and thresholds (K = 16 and 40) bit for bit,
    images within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxf_impl, tiled
    source = f'softras_{route}_fwd'
    for rgb, K in (('hard', 16), ('softmax', 40)):
        x, t, p, pin = tile_split_inputs(route, 'long', rgb, K)
        with_thr = route == 'pxf'
        bounds = pxf_impl.thr_bisect_bounds(p.near, p.far) if with_thr else (0, 0, 0)
        img, ag, cnt, thr = tile_split_launch(route, pin, p)
        for split in (2, 4):
            args, (img_v, ag_v, cnt_v, thr_v) = tiled.fwd_args(pin, p, with_thr, bounds)
            cuda_impl._run(tiled.split_variant(source, split), source, args, x.device)
            torch.cuda.synchronize()
            assert torch.equal(cnt, cnt_v), split
            torch.testing.assert_close(img_v, img, atol=1e-5, rtol=0)
            if rgb == 'hard':
                assert torch.equal(ag, ag_v), split
            if with_thr:
                assert torch.equal(thr, thr_v), split


# K4 and K6 (csrc/softras_tile_bwd.cuh) give each entry's row to one warp,
# which walks the face's bbox inside the tile in a fixed order: every build
# (register cap, warps taking faces from a counter, texel adds in rounds) and
# every work-item size gives the same rows, bit for bit.
TILE_BWD_BUILDS = ('000', '300', '010', '001', '301', '311', '411')


def tile_bwd_case(route, kind, group=None):
    """A dense soup at 128 px (every tile's list many items long) with two
    screen-filling faces on the route, the forward's outputs and a seeded
    incoming gradient: (pin, images, aggrs, thr, grad, params).  ``kind``:
    'surface' (T = 4, softmax), 'vertex' (vertex colours) or 'hard'
    (hard rgb and alpha, barycentric distance); px_f at K = 4 (binding)."""
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl, tiled
    vertex = kind == 'vertex'
    x, t = dense_soup(30, F=1500, T=3 if vertex else 4)
    x = with_big_faces(x)
    t = t.reshape(1, -1, 3, 3) if vertex else tie_symmetric(t)
    kw = dict(image_size=128, sigma_val=1e-4, gamma_val=1e-3 if not vertex else 0.1)
    if vertex:
        kw.update(texture_type='vertex', fill_back=False)
    if kind == 'hard':
        kw.update(dist_func='barycentric', aggr_func_rgb='hard', aggr_func_alpha='hard')
    if route == 'fpx':
        p = make_params(grad_mode='full', **kw)
        th, tw = fpx_impl.tile_shape(128)
        group = group or fpx_impl.GROUP
    else:
        p = make_params(max_faces_per_pixel_for_grad=4, **kw)
        th = tw = pxf_impl.tile_for(128)
        group = group or pxf_impl.GROUP
    pin = tiled.prep(x, t, p, th, tw, group, for_grad=True)
    if route == 'fpx':
        img, ag, _, thr = fpx_impl.launch_fpx_fwd(pin, p)
    else:
        img, ag, _, thr = pxf_impl.launch_pxf_fwd(pin, p, True)
    g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(8),
                    device='cuda')
    return pin, img, ag, thr, g, p


def tile_bwd_wrapper(route):
    from jrender_tpu_torch.ops.softras import fpx_impl, pxf_impl
    return fpx_impl.launch_fpx_bwd if route == 'fpx' else pxf_impl.launch_pxf_bwd


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['surface', 'vertex', 'hard'])
@pytest.mark.parametrize('route', ['fpx', 'pxf'])
def test_softras_tile_bwd_builds_and_items_agree(route, kind):
    """K4 or K6: the default build twice, every build of TILE_BWD_BUILDS
    and items of 1, 8, 32 and 128 faces give the same rows, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import tiled
    source = f'softras_{route}_bwd'
    _build.build([(source, tiled.bwd_defines(b)) for b in TILE_BWD_BUILDS])
    pin, img, ag, thr, g, p = tile_bwd_case(route, kind)
    assert int((pin.tile_off[1:] - pin.tile_off[:-1]).max()) > 128
    launch = tile_bwd_wrapper(route)
    rows = launch(pin, img, ag, thr, g, p)
    again = launch(pin, img, ag, thr, g, p)
    torch.cuda.synchronize()
    assert torch.equal(rows, again)
    for b in TILE_BWD_BUILDS:
        args, rows_b = tiled.bwd_args(pin, img, ag, thr, g, p)
        cuda_impl._run(tiled.bwd_variant(source, tiled.bwd_defines(b)), source, args,
                       img.device)
        torch.cuda.synchronize()
        assert torch.equal(rows_b, rows), b
    for group in (1, 8, 32, 128):
        pin_g = tile_bwd_case(route, kind, group)[0]
        assert torch.equal(pin_g.entries, pin.entries)
        assert int((pin_g.items[:, 2] - pin_g.items[:, 1]).max()) <= group
        assert torch.equal(launch(pin_g, img, ag, thr, g, p), rows), group


# K9 (csrc/softras_pxg_bwd.cu) is the same tile backward on the pxg route's
# 16 x 16 tiles: every build (pxg_impl.BWD_BUILDS) and every work-item size
# gives the same rows, bit for bit.  K7 (csrc/softras_pxg_fwd.cu) walks an
# item's faces in list order at every register cap (pxg_impl.FWD_CAPS): its
# partial rows and depth lists are bit-equal across builds.


def pxg_case(kind, group=None):
    """tile_bwd_case's dense soup on the pxg route at K = 4 (binding), the
    forward's outputs and a seeded incoming gradient: (pin, images, aggrs,
    thr, grad, params); work items of ``group`` faces (the route's
    default)."""
    from jrender_tpu_torch.ops.softras import pxg_impl
    vertex = kind == 'vertex'
    x, t = dense_soup(30, F=1500, T=3 if vertex else 4)
    x = with_big_faces(x)
    t = t.reshape(1, -1, 3, 3) if vertex else tie_symmetric(t)
    kw = dict(image_size=128, sigma_val=1e-4, gamma_val=1e-3 if not vertex else 0.1,
              max_faces_per_pixel_for_grad=4)
    if vertex:
        kw.update(texture_type='vertex', fill_back=False)
    if kind == 'hard':
        kw.update(dist_func='barycentric', aggr_func_rgb='hard', aggr_func_alpha='hard')
    p = make_params(**kw)
    pin = pxg_impl.prep_pxg(x, t, p, for_grad=True, group=group or pxg_impl.GROUP)
    img, ag, _, thr = pxg_impl.forward(pin, p, True)
    g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(8),
                    device='cuda')
    return pin, img, ag, thr, g, p


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['surface', 'vertex', 'hard'])
def test_softras_pxg_bwd_builds_and_items_agree(kind):
    """K9: the default build twice, every build of ``pxg_impl.BWD_BUILDS``
    and work items of 1, 8, 32 and 64 faces give the same rows, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import pxg_impl, tiled
    _build.build([('softras_pxg_bwd', tiled.bwd_defines(b)) for b in pxg_impl.BWD_BUILDS])
    pin, img, ag, thr, g, p = pxg_case(kind)
    assert int((pin.tile_off[1:] - pin.tile_off[:-1]).max()) > 64
    rows = pxg_impl.launch_pxg_bwd(pin, img, ag, thr, g, p)
    again = pxg_impl.launch_pxg_bwd(pin, img, ag, thr, g, p)
    torch.cuda.synchronize()
    assert torch.equal(rows, again)
    for b in pxg_impl.BWD_BUILDS:
        args, rows_b = tiled.bwd_args(pxg_impl.bwd_view(pin, p), img, ag, thr, g, p)
        cuda_impl._run(tiled.bwd_variant('softras_pxg_bwd', tiled.bwd_defines(b)),
                       'softras_pxg_bwd', args, img.device)
        torch.cuda.synchronize()
        assert torch.equal(rows_b, rows), b
    for group in (1, 8, 32, 64):
        pin_g = pxg_case(kind, group)[0]
        assert torch.equal(pin_g.entries, pin.entries)
        assert int((pin_g.items[:, 2] - pin_g.items[:, 1]).max()) <= group
        assert torch.equal(pxg_impl.launch_pxg_bwd(pin_g, img, ag, thr, g, p), rows), group


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['surface', 'vertex', 'hard'])
def test_softras_pxg_fwd_builds_agree(kind):
    """K7: the default build twice and every cap of ``pxg_impl.FWD_CAPS``
    give the same partial rows and depth lists, with and without the lists, bit
    for bit, at the route's items of 64 faces and at items of 2."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import pxg_impl
    _build.build([('softras_pxg_fwd', pxg_impl.fwd_defines(b)) for b in pxg_impl.FWD_CAPS])
    for group, lists in ((pxg_impl.GROUP, True), (pxg_impl.GROUP, False), (2, True)):
        pin, _, _, _, _, p = pxg_case(kind, group=group)
        assert int((pin.item_off[1:] - pin.item_off[:-1]).max()) > 1
        parts, depths = pxg_impl.launch_pxg_fwd(pin, p, lists)
        again = pxg_impl.launch_pxg_fwd(pin, p, lists)
        torch.cuda.synchronize()
        assert torch.equal(parts, again[0])
        assert (depths is None) == (not lists)
        if lists:
            assert torch.equal(depths, again[1])
        for b in pxg_impl.FWD_CAPS:
            defines = pxg_impl.fwd_defines(b)
            args, (parts_b, depths_b) = pxg_impl.fwd_args(pin, p, lists)
            cuda_impl._run(pxg_impl.fwd_variant(defines), 'softras_pxg_fwd', args, parts.device)
            torch.cuda.synchronize()
            assert torch.equal(parts_b, parts), (b, lists)
            if lists:
                assert torch.equal(depths_b, depths), b
            assert pxg_impl.fwd_occupancy(args, defines)['blocks_per_sm'] >= 1, b


@pytest.mark.gpu
@pytest.mark.parametrize('kind,K', [('surface', 16), ('surface', 40), ('hard', 16),
                                    ('hard', 4)])
def test_softras_pxg_thr_builds_agree(kind, K):
    """K8: the default build twice and every build of ``pxg_impl.THR_BUILDS``
    give the same threshold map, bit for bit, equal to the plain merge (K <=
    32: the register list at K = 16, the shared one at K = 4; the bisection
    at K = 40); one tile alone (``thr_args``' first_tile) gives that tile's
    pixels of the map."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import dataclasses
    from jrender_tpu_torch import _build
    from jrender_tpu_torch.ops.softras import pxg_impl
    _build.build([('softras_pxg_thr', pxg_impl.thr_defines(b)) for b in pxg_impl.THR_BUILDS])
    pin, _, _, _, _, p = pxg_case(kind)
    p = dataclasses.replace(p, max_faces_id=K)
    parts, depths = pxg_impl.launch_pxg_fwd(pin, p, True)
    _, _, cnt = pxg_impl.launch_pxg_combine(pin, parts, p)
    thr = pxg_impl.launch_pxg_thr(pin, depths, cnt, p)
    again = pxg_impl.launch_pxg_thr(pin, depths, cnt, p)
    torch.cuda.synchronize()
    assert torch.equal(thr, again)
    assert (cnt > K).any() and (thr[cnt <= K] == p.far).all()
    if depths is not None:
        assert torch.equal(thr, pxg_impl.thr_plain(pin, depths, cnt, p))
    for b in pxg_impl.THR_BUILDS:
        defines = pxg_impl.thr_defines(b)
        for _ in range(2):
            args, thr_b = pxg_impl.thr_args(pin, depths, cnt, p)
            cuda_impl._run(pxg_impl.thr_variant(defines), 'softras_pxg_thr', args, thr.device)
            torch.cuda.synchronize()
            assert torch.equal(thr_b, thr), b
        assert pxg_impl.thr_occupancy(args, defines)['blocks_per_sm'] >= 1, b
    over = pxg_impl.overfull_tiles(pin, cnt, p).long()
    t = int(over[0])
    args, thr_1 = pxg_impl.thr_args(pin, depths, cnt, p, t, 1)
    cuda_impl._run(pxg_impl.thr_variant(), 'softras_pxg_thr', args, thr.device)
    torch.cuda.synchronize()
    tiles = pxg_impl.tiles_for(p.image_size)
    ty, tx = divmod(t % (tiles * tiles), tiles)
    sl = (t // (tiles * tiles), slice(ty * 16, ty * 16 + 16), slice(tx * 16, tx * 16 + 16))
    assert torch.equal(thr_1[sl], thr[sl])


@pytest.mark.gpu
def test_softras_pxg_thr_reads_nothing_to_the_host():
    """The pxg forward after the prep, the threshold included, runs under
    ``torch.cuda.set_sync_debug_mode('error')``: no host synchronisation."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.ops.softras import pxg_impl
    pin, _, _, _, _, p = pxg_case('surface')
    for with_thr in (True, False):
        pxg_impl.forward(pin, p, with_thr)            # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        img, ag, cnt, thr = pxg_impl.forward(pin, p, True)
        thr2 = pxg_impl.launch_pxg_thr(pin, pxg_impl.launch_pxg_fwd(pin, p, True)[1], cnt, p)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert torch.equal(thr, thr2) and (cnt > p.max_faces_id).any()


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


# -- bands of tile rows (pixel-band sharding) ------------------------------------

def _band(n, mode, r, tiles):
    """Rank r's band (ty0, ty_band, ty_stride) of ``tiles`` tile rows over n."""
    per = tiles // n
    return (r, per, n) if mode == 'stride' else (r * per, per, 1)


@pytest.mark.gpu
@pytest.mark.parametrize('is_', [128, 256])
@pytest.mark.parametrize('n,mode', [(1, 'contig'), (2, 'stride'), (2, 'contig'),
                                    (4, 'stride'), (4, 'contig')])
def test_softras_band_kernels_equal_the_whole_image(is_, n, mode):
    """K1, its threshold, K2 and the reduction on each band of n: the band's
    image, aggregates, counts and threshold are the whole image's rows and
    its slot rows the whole image's, bit for bit (a tile's walk does not
    depend on the band; the band (0, tiles, 1) gives every output of the
    call without a band, big-face rows included); the reduction equals its
    plain version; the bands' gradients summed lie within 1e-5 of the whole
    image's max (the big faces' rows add over the bands in another order).
    B = 2, big faces, T = 4, K = 4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    x, t = soup(21, F=400, B=2, T=4)
    x, t = with_big_faces(x), tie_symmetric(t)
    p = make_params(image_size=is_, sigma_val=1e-3, gamma_val=1e-3,
                    max_faces_per_pixel_for_grad=4)

    def inputs(band):
        # an emit cap of 6: a face over more than 6 tiles is a big face
        x_in = cuda_impl.prepare(x, t, p, for_grad=True, band=band)
        return x_in._replace(lists=binning.build_tile_lists_compact(
            x, is_, cuda_impl.TILE, cuda_impl.TILE, p.threshold, 6, with_inverse=True,
            band=band))

    whole = inputs(None)
    assert int(whole.lists.gcount.min()) >= 2
    img, ag, cnt = cuda_impl.launch(whole, p)
    thr = cuda_impl.launch_thr(whole, cnt, p)
    g = torch.randn(img.shape, generator=torch.Generator(device='cuda').manual_seed(9),
                    device='cuda')
    rows_w = cuda_impl.launch_bwd(whole, img, ag, thr, g, p)
    gf_w, gt_w = cuda_impl.launch_reduce(whole, rows_w, p)
    gf_s, gt_s = torch.zeros_like(gf_w), torch.zeros_like(gt_w)
    tiles = is_ // cuda_impl.TILE
    for r in range(n):
        band = _band(n, mode, r, tiles)
        xb = inputs(band)
        rows = cuda_impl.band_rows(is_, band).cuda()
        bi, ba, bc = cuda_impl.launch(xb, p)
        bt = cuda_impl.launch_thr(xb, bc, p)
        rb = cuda_impl.launch_bwd(xb, bi, ba, bt, g[:, :, rows].contiguous(), p)
        gf, gt = cuda_impl.launch_reduce(xb, rb, p)
        torch.cuda.synchronize()
        for got, want in ((bi, img), (ba, ag), (bc, cnt), (bt, thr)):
            assert torch.equal(got, want.index_select(-2, rows))
        for b in range(2):
            sb, sw = xb.lists.gsrc[b], whole.lists.gsrc[b]
            emitted = sb >= 0
            assert torch.equal(rb.gslots[b, sb[emitted]], rows_w.gslots[b, sw[emitted]])
        for a, w in zip((gf, gt), cuda_impl.reduce_rows_plain(xb, rb, p)):
            assert torch.equal(a, w)
        if n == 1:
            for b in range(2):        # the rows past a batch element's big faces are unset
                nb = int(whole.lists.gcount[b])
                assert torch.equal(rb.gbig[b, :nb], rows_w.gbig[b, :nb])
            assert torch.equal(gf, gf_w) and torch.equal(gt, gt_w)
        gf_s, gt_s = gf_s + gf, gt_s + gt
    for got, want in ((gf_s, gf_w), (fold_ties(gt_s), fold_ties(gt_w))):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['pxt', 'px_f'])
def test_soft_rasterize_sharded_one_rank_is_soft_rasterize(layout, tmp_path, monkeypatch):
    """The sharded path through a one-rank NCCL group is ``soft_rasterize``,
    bit for bit (image and both gradients), on the binned band kernels and
    under ``JR_LAYOUT=px_f`` on the px_f ones."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import torch.distributed as dist
    from jrender_tpu_torch.ops.softras import soft_rasterize
    from jrender_tpu_torch.parallel import make_device_mesh, soft_rasterize_sharded
    monkeypatch.setenv('JR_LAYOUT', layout)
    monkeypatch.delenv('JR_DIR_MAX', raising=False)
    x, t = soup(22, F=300, T=4)
    g = torch.randn((1, 4, 128, 128), generator=torch.Generator(device='cuda').manual_seed(2),
                    device='cuda')
    kw = dict(image_size=128, sigma_val=1e-3, gamma_val=1e-3, max_faces_per_pixel_for_grad=8)
    dist.init_process_group('nccl', init_method=f'file://{tmp_path / "store"}', rank=0,
                            world_size=1)
    try:
        mesh = make_device_mesh(1, 1)
        outs = []
        for sharded in (False, True):
            xl, tl = x.clone().requires_grad_(True), t.clone().requires_grad_(True)
            img = (soft_rasterize_sharded(xl, tl, make_params(**kw), mesh) if sharded
                   else soft_rasterize(xl, tl, **kw))
            (img * g).sum().backward()
            outs.append((img.detach(), xl.grad, tl.grad))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- the Hopper probes of the TPU tools (jrender_tpu_torch/probes/) ----------------------
# T1 without products bit-equal to its plain version (the kernel's FMAs in its
# order of sums), with products and T2 within rtol 1e-5 (float32 both, the
# sums in other orders; the products on the tensor cores in 3xTF32), T2's
# checksums of the staged bits exactly; two runs bit-equal.

def _probe_rel(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize('ffma', [False, True], ids=['mma', 'ffma'])
@pytest.mark.parametrize('n,t2,case', [
    (5, 64, (7, 3, 19, 2)),
    (838, 1024, (20, 0, 0, 25)),
    (838, 256, (100, 90, 90, 3)),
    (838, 1024, (23, 7, 9, 0)),
], ids=['small', 'full-dot25', 'full-T2=256', 'full-tail'])
def test_probe_micro_kernel_matches_plain(n, t2, case, ffma):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.probes import micro
    data = torch.tensor(np.random.RandomState(n).uniform(size=(n, 16, 128)).astype(np.float32),
                        device='cuda')
    got = micro.launch_micro(data, *case, t2, ffma=ffma)
    again = micro.launch_micro(data, *case, t2, ffma=ffma)
    torch.cuda.synchronize()
    want = micro.run_plain(data, *case, t2)
    if case[3] == 0:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _probe_rel(got.out, want.out) <= 1e-5
    assert _probe_rel(got.partial, want.partial) <= 1e-5
    assert _probe_rel(got.dots, want.dots) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize('variant,dot', [(v, 'mma') for v in ('base', 'dma16', 'dma1r', 'tr256',
                                                                'dots')]
                         + [('dots', 'ffma'), ('dots', 'adds')])
@pytest.mark.parametrize('n,ntt', [(6, 10), (3973, 4096)], ids=['small', 'full'])
def test_probe_bwd_dma_kernel_matches_plain(n, ntt, variant, dot):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.probes import bwd_dma
    face, px, seg = bwd_dma.inputs(n, ntt, seed=n, device='cuda')
    got = bwd_dma.launch_bwd_dma(face, px, seg, variant, dot)
    again = bwd_dma.launch_bwd_dma(face, px, seg, variant, dot)
    torch.cuda.synchronize()
    want = bwd_dma.run_plain(face, px, seg, variant)
    assert _probe_rel(got.gout, want.gout) <= 1e-5
    assert torch.equal(got.stage_sum, want.stage_sum)
    assert (got.stage_sum != 0).any() == (variant != 'base')
    assert torch.equal(got.gout, again.gout) and torch.equal(got.stage_sum, again.stage_sum)


@pytest.mark.gpu
def test_probe_wrappers_refuse_bad_cuda_inputs():
    """A CUDA input the kernels do not take raises; nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from jrender_tpu_torch.probes import bwd_dma, micro
    data = torch.zeros((4, 16, 128), device='cuda')
    with pytest.raises(ValueError, match='multiple of 32'):
        micro.run(data, 1, 0, 0, 0, 100)
    with pytest.raises(ValueError, match='data must be'):
        micro.run(torch.zeros((4, 16, 64), device='cuda'), 1, 0, 0, 0, 64)
    with pytest.raises(TypeError, match='float32'):
        micro.run(data.double(), 1, 0, 0, 0, 64)
    face, px, seg = bwd_dma.inputs(3, 8, device='cuda')
    with pytest.raises(ValueError, match='seg must lie'):
        bwd_dma.run(face, px[:20], seg + 4, 'dma1r')
    rows = px.shape[0] - 1
    shifted = px.reshape(-1)[1:1 + rows * 16 * 256].view(rows, 16, 256)   # 4 B off
    with pytest.raises(ValueError, match='16-byte'):
        bwd_dma.run(face, shifted, seg, 'dma16')
    with pytest.raises(TypeError, match='int32'):
        bwd_dma.run(face, px, seg.long(), 'dma16')
