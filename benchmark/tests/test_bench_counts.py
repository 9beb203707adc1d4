"""The work counts of a tiny mesh against a count made by hand, the least
time's arithmetic, and the import guard's whole-name comparison."""
import torch

from benchmark.harness import guard, peaks
from benchmark.reference import n3mr, softras


def _half_plane_face(z=2.0):
    """One face over an 8 x 8 image: (-1,-1), (1,-1), (-1,1) at depth z.
    Its hypotenuse x + y = 0 runs through the pixel centres of the
    diagonal: 28 pixel centres lie strictly inside, 8 on the edge, 28
    outside and at least 0.17 from it, all 64 in its bounding box."""
    return torch.tensor([[-1.0, -1.0, z, 1.0, -1.0, z, -1.0, 1.0, z]])


def test_softras_census_by_hand():
    c = softras.census_view(_half_plane_face(), softras.Params(image_size=8))
    # closed inside test: the diagonal counts; the distance cut (sigma
    # 1e-5: 0.0096) reaches no outside centre; a pixel has one candidate,
    # under K = 16, so the threshold keeps each
    assert c == {'in_bbox': 64, 'inside': 36, 'candidates': 36, 'within_thr': 36,
                 'drawn': 36}


def test_n3mr_census_by_hand():
    face = _half_plane_face()
    # N3MR draws faces wound the other way; a centre on an edge has a
    # cross product of 0, which its test keeps
    if not n3mr.frontside(face)[0]:
        face = face.reshape(1, 3, 3).flip(1).reshape(1, 9)
    c = n3mr.census_view(face, 8, 0.1, 100.0)
    assert (c['front_pairs'], c['inside'], c['drawn']) == (64, 36, 36)
    # the three edges cross 8, 8 and 0 + 8 rows on each axis at most
    assert 0 < c['edge_rows'] <= 3 * 2 * 8


def test_softras_least_work_arithmetic():
    c = {'in_bbox': 10, 'inside': 4, 'candidates': 5, 'within_thr': 3}
    ops, nbytes = softras.least_work(c, 2, 7, 25, 8, backward=False)
    assert ops == 10 * 65 + 4 * 56 + 5 * 60
    assert nbytes == 4 * 2 * 7 * (9 + 75) + 4 * 2 * 4 * 64
    ops_b, nbytes_b = softras.least_work(c, 2, 7, 25, 8, backward=True)
    assert ops_b == ops + 5 * 2 + 3 * 120 and nbytes_b == 2 * nbytes


def test_least_seconds_takes_the_longer_bound():
    kind = 'NVIDIA H100 80GB HBM3'
    assert peaks.least_seconds(67e12, 0, kind) == 1.0
    assert peaks.least_seconds(0, 3.35e12, kind) == 1.0
    assert peaks.least_seconds(67e12, 2 * 3.35e12, kind) == 2.0


def test_guard_compares_whole_top_level_names():
    mods = ['jrender_tpu_torch', 'jrender_tpu_torch.ops.softras', 'jax_fake', 'jaxify',
            'torch', 'benchmark.harness']
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ['jax.numpy']) == ['jax']
    assert guard.forbidden_modules(['jrender_tpu.ops', 'jaxlib', 'flax.linen']) == \
        ['flax', 'jaxlib', 'jrender_tpu']
