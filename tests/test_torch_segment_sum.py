"""The port's fixed-order sums by segment (``ops/segment_sum.py``), on the CPU.

Vertex normals (``structures/mesh.py``) and N3MR's depth gradient
(``ops/n3mr/torch_impl.py``) summed with ``index_add_``, which adds with
float atomics on a card.  They now sum through a stable sort of the
segment ids and the segment-sum kernel (``csrc/segment_sum.cu``; on the
CPU its plain version).
These tests hold the new sums against the old ``index_add_`` ones within
1e-6 relative (another order of the same float32 additions), the order
the kernel walks against its definition, and the gradient (a gather)
against autograd's.  The kernel itself is held against this plain version
on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 10b),
where both sums run twice to the same bits.
"""
import numpy as np
import pytest
import torch

from jrender_tpu_torch.ops import segment_sum as ss
from jrender_tpu_torch.ops.n3mr import torch_impl as ntorch
from jrender_tpu_torch.structures import face_vertices, vertex_normals_fn
from jrender_tpu_torch.utils.math import normalize
from jrender_tpu_torch.utils.primitives import uv_sphere

torch.set_num_threads(2)


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize('C', [3, 9, 12])
def test_segment_order_and_sum(C):
    """``order`` lists each segment's rows in ascending place, ``off`` its
    range; rows at or past the segment count are dropped; the sum in that
    order equals ``index_add_``'s within 1e-6 relative."""
    rng = np.random.RandomState(C)
    seg = torch.tensor(rng.randint(0, 60, size=500))          # 50 segments, ids 50-59 dropped
    rows = torch.tensor(rng.randn(500, C).astype(np.float32))
    so = ss.segment_order(seg, 50)
    off, order = so.off.long(), so.order.long()
    for s in range(50):
        got = order[off[s]:off[s + 1]]
        assert torch.equal(got, torch.nonzero(seg == s).reshape(-1))
    assert int(off[-1]) == int((seg < 50).sum())
    # the kernel's walk: each segment's rows added one after the other
    walk = torch.stack([rows[order[off[s]:off[s + 1]]].sum(0) if off[s + 1] > off[s]
                        else rows.new_zeros(C) for s in range(50)])
    want = torch.zeros(50, C).index_add_(0, seg[seg < 50], rows[seg < 50])
    got = ss.segment_sum(rows, so)
    assert rel_err(got, want) <= 1e-6 and rel_err(walk, want) <= 1e-6
    with pytest.raises(ValueError):
        ss.launch_segment_sum(rows, so)                       # CPU tensors


def test_segment_sum_gradient_is_a_gather():
    rng = np.random.RandomState(1)
    seg = torch.tensor(rng.randint(0, 12, size=40))
    rows = torch.tensor(rng.randn(40, 3), requires_grad=True)
    so = ss.segment_order(seg, 10)
    g = torch.tensor(rng.randn(10, 3))
    (ss.SegmentSum.apply(rows, so) * g).sum().backward()
    want = torch.where((seg < 10)[:, None], g[seg.clamp_max(9)], 0.0)
    assert torch.equal(rows.grad, want)


def old_vertex_normals(vertices, faces):
    """``vertex_normals_fn`` before the repair: three ``index_add_``s."""
    bs, nv = vertices.shape[:2]
    fv = face_vertices(vertices, faces)
    n = torch.stack([
        torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0], dim=-1),
        torch.linalg.cross(fv[:, :, 2] - fv[:, :, 1], fv[:, :, 0] - fv[:, :, 1], dim=-1),
        torch.linalg.cross(fv[:, :, 0] - fv[:, :, 2], fv[:, :, 1] - fv[:, :, 2], dim=-1),
    ], dim=2)
    offs = torch.arange(bs)[:, None, None] * nv
    acc = torch.zeros((bs * nv, 3), dtype=vertices.dtype)
    for k in range(3):
        acc.index_add_(0, (faces[:, :, k:k + 1].long() + offs).reshape(-1),
                       n[:, :, k].reshape(-1, 3))
    return normalize(acc.reshape(bs, nv, 3), axis=2, eps=1e-6)


def test_vertex_normals_equal_the_index_add_ones():
    """Two batch elements of a scaled sphere: normals and their gradient
    within 1e-6 relative of the ``index_add_`` version."""
    v, f = uv_sphere(12, 14)
    rng = np.random.RandomState(2)
    v = torch.tensor((v[None] * rng.uniform(0.8, 1.2, (2, 1, 3))).astype(np.float32))
    f = torch.tensor(f[None].repeat(2, 0))
    g = torch.tensor(rng.randn(*v.shape).astype(np.float32))
    x, y = v.clone().requires_grad_(True), v.clone().requires_grad_(True)
    a, b = vertex_normals_fn(x, f), old_vertex_normals(y, f)
    (a * g).sum().backward()
    (b * g).sum().backward()
    assert rel_err(a, b) <= 1e-6
    assert rel_err(x.grad, y.grad) <= 1e-6


def test_n3mr_depth_gradient_equals_the_index_add_one():
    """``backward_depth`` on the plain z-buffer's maps of a soup, B = 2,
    within 1e-6 relative of the ``index_add_`` sum per face."""
    rng = np.random.RandomState(3)
    B, F, is_ = 2, 60, 48
    xy = rng.uniform(-0.9, 0.9, size=(B, F, 3, 2))
    z = rng.uniform(1.2, 4.0, size=(B, F, 3, 1))
    face = torch.tensor(np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9))
    fi, wt, dp, finv, zc = ntorch.forward_maps(face, is_, 0.1, 100.0)
    gd = torch.tensor(rng.randn(*dp.shape).astype(np.float32))
    got = ntorch.backward_depth(face, fi, finv, wt, dp, zc, gd)
    # the same per-pixel rows, added with index_add_
    seg = torch.where(fi.reshape(B, -1) >= 0, fi.reshape(B, -1).long()
                      + torch.arange(B)[:, None] * F, B * F).reshape(-1)
    captured = {}
    real = ss.segment_sum

    def capture(rows, so):
        captured['rows'] = rows
        return real(rows, so)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ntorch, 'segment_sum', capture)
        again = ntorch.backward_depth(face, fi, finv, wt, dp, zc, gd)
    want = torch.zeros((B * F + 1, 9)).index_add_(0, seg, captured['rows'])[:-1].reshape(B, F, 9)
    assert torch.equal(got, again) and got.abs().max() > 0
    assert rel_err(got, want) <= 1e-6
