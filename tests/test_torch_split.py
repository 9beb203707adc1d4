"""The binned forward kernel's split and merge rule, on the CPU.

On the card the binned SoftRas forward (``csrc/softras_fwd.cu``) cuts each
tile's sequence of face ids (its big faces, then its sorted run) into
contiguous shares, one per block of a thread-block cluster, and merges the
blocks' partial states in rank order.  ``cuda_impl.fwd_split_plain`` is the
plain version of that rule: the shares of ``cuda_impl.rank_shares``
aggregated by the pxg partials' plain version and merged by the pxg
combine's.  Here it is held

* against the unsplit plain forward (``torch_impl.soft_rasterize_fwd_plain``):
  candidate counts, hard winners and their depths exactly (the merge picks
  the least depth and the lowest id across shares, as one walk does), images
  and softmax aggregates within 1e-5 (the shares' sums are rescaled and
  added in another order);
* against the JAX oracle (``backend='jax'``) at the JAX suite's image
  tolerances (``tests/test_torch_softras.py``).

The soups are dense at 64 px, so that the busiest tile's sequence has a face
for every rank.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.ops.softras import jax_impl
from jrender_tpu.ops.softras import make_params as jax_params

from jrender_tpu_torch.ops.softras import binning, cuda_impl, make_params, torch_impl

from test_torch_softras import check_images, soup, texel_tie_variants

torch.set_num_threads(2)

SUM_TOL = 1e-5
KW = dict(image_size=64, sigma_val=1e-3, gamma_val=1e-3)


def dense_soup(seed, F=160, T=4):
    """Small faces over the whole 64-px image: every tile's list is long
    (up to 47 faces).  With faces twice as large (radius 0.1-0.3) the
    unsplit plain forward itself has 1.1-1.2% of its pixels beyond the JAX
    suite's tolerance unexplained by texel ties or rounding (knife edges of
    the distance cut, which XLA's contractions move), past its 1%."""
    return soup(np.random.RandomState(seed), F=F, T=T, centre=(-0.8, 0.8),
                radius=(0.05, 0.15))


def split_and_unsplit(fv, tex, p, split, mt=None):
    """(the split-and-merge plain forward, the unsplit one, the lists)."""
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    inputs = cuda_impl.prepare(fvt, text, p)
    if mt is not None:
        inputs = inputs._replace(lists=binning.build_tile_lists_compact(
            fvt, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt))
    return (cuda_impl.fwd_split_plain(inputs, p, split),
            torch_impl.soft_rasterize_fwd_plain(fvt, text, p), inputs.lists)


def assert_merge_exact(got, want, p):
    """Counts and hard winners exact, sums within SUM_TOL."""
    (img, ag, cnt), (img_w, ag_w, cnt_w) = got, want
    assert torch.equal(cnt, cnt_w)
    torch.testing.assert_close(img, img_w, atol=SUM_TOL, rtol=0)
    if p.aggr_func_rgb == 'hard':
        assert torch.equal(ag, ag_w)               # the winner's depth and id
    else:
        torch.testing.assert_close(ag, ag_w, atol=SUM_TOL, rtol=SUM_TOL)


def longest_sequence(lists):
    """The most face ids in one tile's sequence: big faces, then its run."""
    return int(lists.gcount.max()) + int(lists.run_counts.max())


@pytest.mark.parametrize('total,split', [(0, 4), (1, 8), (3, 8), (8, 8), (9, 8), (10, 4),
                                         (1158, 4), (1158, 8), (64, 2)])
def test_rank_shares_cover_the_sequence(total, split):
    shares = cuda_impl.rank_shares(total, split)
    assert len(shares) <= split
    los, his = [lo for lo, _ in shares], [0] + [hi for _, hi in shares]
    assert los == his[:len(los)]                   # contiguous, from 0
    assert (shares[-1][1] if shares else 0) == total
    per = -(-total // split)
    assert all(0 < hi - lo <= per for lo, hi in shares)
    if total <= 1:
        assert len(shares) == total                # rank 0 alone, or no rank


@pytest.mark.parametrize('alpha', ['hard', 'sum', 'prod'])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
@pytest.mark.parametrize('split', [2, 8])
def test_split_merge_matches_unsplit(split, rgb, alpha):
    fv, tex = dense_soup(1)
    p = make_params(aggr_func_rgb=rgb, aggr_func_alpha=alpha, **KW)
    got, want, lists = split_and_unsplit(fv, tex, p, split)
    assert longest_sequence(lists) >= 4 * split    # every rank of the busiest tile works
    assert_merge_exact(got, want, p)


_ORACLE = {}


def _oracle(fv, tex, kw):
    """The JAX oracle's (image, aggrs), computed once per configuration."""
    key = tuple(sorted(kw.items()))
    if key not in _ORACLE:
        out, ag, _ = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                     jax_params(**kw))
        _ORACLE[key] = (np.asarray(out), np.asarray(ag))
    return _ORACLE[key]


@pytest.mark.parametrize('alpha', ['hard', 'sum', 'prod'])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_split_merge_matches_jax_oracle(rgb, alpha):
    fv, tex = dense_soup(1)
    kw = dict(aggr_func_rgb=rgb, aggr_func_alpha=alpha, **KW)
    p = make_params(**kw)
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    inputs = cuda_impl.prepare(fvt, text, p)
    oj, aj = _oracle(fv, tex, kw)
    ot, at, _ = cuda_impl.fwd_split_plain(inputs, p, 8)
    ties = texel_tie_variants(lambda: cuda_impl.fwd_split_plain(inputs, p, 8)[0])
    exact = torch_impl.soft_rasterize_fwd_plain(fvt.double(), text.double(), p)[0]
    check_images(oj, aj, ot.numpy(), at.numpy(), ties, exact.numpy(),
                 softmax=rgb == 'softmax')


@pytest.mark.parametrize('mt', [None, 2])
@pytest.mark.parametrize('split', [2, 8])
def test_split_ties_go_to_the_lowest_id(split, mt):
    """Faces F..2F-1 repeat faces 0..F-1 (other colours): every depth tie
    between a face and its twin, which lie in different shares of a long
    sequence, goes to the lower id; with an emit cap of 2 tiles most twins
    are big faces, and the big-face prefix crosses rank boundaries."""
    fv, tex = dense_soup(2, F=80)
    fv2 = np.concatenate([fv, fv], axis=1)
    tex2 = np.concatenate([tex, tex[..., ::-1]], axis=1).copy()
    p = make_params(aggr_func_rgb='hard', **KW)
    got, want, lists = split_and_unsplit(fv2, tex2, p, split, mt)
    assert_merge_exact(got, want, p)
    won = got[1][:, 1]
    assert (won >= 0).any() and not (won >= 80).any()
    if mt is not None:
        per = -(-longest_sequence(lists) // split)
        assert int(lists.gcount.max()) > per       # the big faces span ranks


@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_split_lone_faces_rank_zero_alone(rgb):
    """One small face in each of a few tiles: every sequence holds at most
    one face, which rank 0 walks alone."""
    rng = np.random.RandomState(4)
    centres = [(-0.75, -0.75), (-0.25, 0.25), (0.25, -0.25), (0.75, 0.75)]
    fv = np.array([[[x - 0.05, y - 0.05, 2.5, x + 0.05, y - 0.05, 2.4, x, y + 0.05, 2.6]
                    for x, y in centres]], np.float32)
    tex = rng.uniform(size=(1, len(centres), 4, 3)).astype(np.float32)
    p = make_params(aggr_func_rgb=rgb, image_size=64)
    got, want, lists = split_and_unsplit(fv, tex, p, 8)
    assert longest_sequence(lists) == 1
    assert_merge_exact(got, want, p)


@pytest.mark.parametrize('T', [1, 25, 324, 4096])
def test_staged_chunk_fits_the_block(T):
    """The binned forward and backward stage two chunks of face rows: as
    many faces as fit 48 KB besides the block's own, at least one; a row
    of many texels asks past 48 KB, up to the block's most."""
    row = cuda_impl.ROW_BASE + 3 * T
    for reserved in (0, cuda_impl.bwd_reserved_bytes(3 * T)):
        per_face = 2 * (4 * row + 4)
        if reserved + per_face > cuda_impl.SMEM_MAX_BYTES:
            with pytest.raises(ValueError):
                cuda_impl.staged_chunk(row, reserved)
            continue
        chunk = cuda_impl.staged_chunk(row, reserved)
        assert 1 <= chunk <= cuda_impl.MAX_CHUNK
        assert chunk == 1 or chunk * per_face + reserved <= cuda_impl.SMEM_BYTES
        assert (chunk + 1) * per_face + reserved > cuda_impl.SMEM_BYTES \
            or chunk == cuda_impl.MAX_CHUNK


# --------------------------------------------------------------------------
# the threshold kernel's split and merge
# --------------------------------------------------------------------------
#
# On the card the threshold kernel (``csrc/softras_thr.cu``) cuts each
# tile's sequence into the same shares as the forward, keeps each share's K
# smallest candidate depths per pixel (or, for K > 32, counts each share's
# candidates at or below a bisection's trial value) and merges the shares.
# ``cuda_impl.thr_split_plain`` is the plain version of that rule; the K-th
# smallest of a union is a value of the union, so the merge is exact:
# the maps must equal the unsplit plain threshold to the bit.

THR_KW = dict(image_size=64, sigma_val=1e-3)


def thr_soup(seed, F=300):
    """Large faces over the whole 64-px image: 36 candidates a pixel on
    average, up to about 70, so that K = 40 binds, and sequences of up to
    F faces a tile."""
    return soup(np.random.RandomState(seed), F=F, T=1, centre=(-0.8, 0.8),
                radius=(0.3, 0.6))


def thr_split_and_unsplit(fv, tex, p, split, mt=None):
    """(the split-and-merge plain threshold, the unsplit one, the counts,
    the lists)."""
    fvt, text = torch.tensor(fv), torch.tensor(tex)
    inputs = cuda_impl.prepare(fvt, text, p)
    if mt is not None:
        inputs = inputs._replace(lists=binning.build_tile_lists_compact(
            fvt, p.image_size, cuda_impl.TILE, cuda_impl.TILE, p.threshold, mt))
    _, _, counts = torch_impl.soft_rasterize_fwd_plain(fvt, text, p)
    return (cuda_impl.thr_split_plain(inputs, counts, p, split),
            torch_impl.topk_threshold_plain(fvt, p), counts, inputs.lists)


@pytest.mark.parametrize('K', [1, 4, 16, 40])
@pytest.mark.parametrize('split', [1, 2, 4, 8])
def test_thr_split_matches_unsplit(split, K):
    fv, tex = thr_soup(5)
    p = make_params(max_faces_per_pixel_for_grad=K, **THR_KW)
    got, want, counts, lists = thr_split_and_unsplit(fv, tex, p, split)
    assert longest_sequence(lists) >= 4 * split    # every rank of the busiest tile works
    assert (counts > K).float().mean() > 0.2 and (counts <= K).any()
    assert torch.equal(got, want)
    assert (got[counts <= K] == p.far).all()


@pytest.mark.parametrize('dist', ['hard', 'barycentric'])
def test_thr_split_other_distances(dist):
    fv, tex = thr_soup(6)
    p = make_params(max_faces_per_pixel_for_grad=4, dist_func=dist, **THR_KW)
    got, want, counts, _ = thr_split_and_unsplit(fv, tex, p, 8)
    assert (counts > 4).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize('K', [4, 40])
def test_thr_split_big_faces_cross_ranks(K):
    """An emit cap of 2 tiles: most faces are big, and the big-face prefix
    of a tile's sequence spans several ranks' shares."""
    fv, tex = thr_soup(7)
    p = make_params(max_faces_per_pixel_for_grad=K, **THR_KW)
    got, want, _, lists = thr_split_and_unsplit(fv, tex, p, 8, mt=2)
    assert int(lists.gcount.max()) > 2 * -(-longest_sequence(lists) // 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize('K', [1, 2, 3, 4])
def test_thr_split_twins_count_with_multiplicity(K):
    """Faces F..2F-1 repeat faces 0..F-1: every depth comes twice, from
    different shares, and counts twice towards K, so the K-th smallest is
    the ceil(K/2)-th smallest of the faces once."""
    fv, tex = thr_soup(8, F=100)
    fv2 = np.concatenate([fv, fv], axis=1)
    tex2 = np.concatenate([tex, tex], axis=1)
    p = make_params(max_faces_per_pixel_for_grad=K, **THR_KW)
    got, want, counts, _ = thr_split_and_unsplit(fv2, tex2, p, 8)
    assert torch.equal(got, want)
    K1 = (K + 1) // 2
    p1 = make_params(max_faces_per_pixel_for_grad=K1, **THR_KW)
    once, _, c1, _ = thr_split_and_unsplit(fv, tex, p1, 8)
    both = (counts > K) & (c1 > K1)
    assert both.float().mean() > 0.2
    assert torch.equal(got[both], once[both])


def test_thr_split_lone_faces():
    """One small face in each of a few tiles: no pixel has more than K = 1
    candidates, so the threshold is `far` everywhere."""
    centres = [(-0.75, -0.75), (-0.25, 0.25), (0.25, -0.25), (0.75, 0.75)]
    fv = np.array([[[x - 0.05, y - 0.05, 2.5, x + 0.05, y - 0.05, 2.4, x, y + 0.05, 2.6]
                    for x, y in centres]], np.float32)
    tex = np.random.RandomState(4).uniform(size=(1, len(centres), 1, 3)).astype(np.float32)
    p = make_params(max_faces_per_pixel_for_grad=1, image_size=64)
    got, want, counts, lists = thr_split_and_unsplit(fv, tex, p, 8)
    assert longest_sequence(lists) == 1 and int(counts.max()) == 1
    assert torch.equal(got, want) and (got == p.far).all()


@pytest.mark.parametrize('K', [4, 16])
def test_thr_split_matches_jax_oracle(K):
    """The threshold is the depth of the oracle's K-th face id
    (``backend='jax'``'s third forward output) where a pixel has more than
    K candidates; two roundings of a near tie may order two faces apart at
    a few pixels, as in ``test_torch_softras.test_topk_threshold_and_face_ids``."""
    fv, tex = thr_soup(9, F=120)
    kw = dict(max_faces_per_pixel_for_grad=K, **THR_KW)
    p = make_params(**kw)
    got, _, counts, _ = thr_split_and_unsplit(fv, tex, p, 8)
    _, _, ids_j = jax_impl.soft_rasterize_fwd_jax(jnp.asarray(fv), jnp.asarray(tex),
                                                  jax_params(**kw))
    is_ = p.image_size
    ids_j = torch.tensor(np.asarray(ids_j).reshape(K, -1).T.copy())       # [P, K]
    xp, yp = torch_impl.pixel_grid(is_)
    depth = torch_impl._candidate_depths(torch.tensor(fv)[0], p, xp, yp)
    kth = depth.gather(1, ids_j[:, K - 1:K].long().clamp_min(0))[:, 0]
    over = counts.reshape(-1) > K
    assert over.float().mean() > 0.2
    assert (got.reshape(-1)[over] != kth[over]).float().mean() <= 0.002
