"""The port's losses and demo 2's step pieces against jrender_tpu, on the CPU.

Same numpy inputs, made from a seed, go to ``jrender_tpu``'s
LaplacianLoss, FlattenLoss and neg_iou_loss and to the port's; values and
gradients (``jax.grad`` against autograd) agree to float32 rounding: rtol
1e-4 with atol 1e-5 of the largest entry, the sums being taken in another
order.  The training state goes across with ``jrender_tpu_torch.convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jrender_tpu as jr
import jrender_tpu_torch as jt
from jrender_tpu_torch import convert, deform
from jrender_tpu_torch.loss import losses as tlosses
from jrender_tpu_torch.utils.primitives import uv_sphere

torch.set_num_threads(2)


def assert_close(actual, expected, rtol=1e-4):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=1e-5 * max(np.abs(expected).max(), 1e-6))


def mesh_and_batch(rng, B=3):
    v, f = uv_sphere(6, 7)
    x = (v[None] + rng.normal(scale=0.05, size=(B,) + v.shape)).astype(np.float32)
    return v, f, x


@pytest.mark.parametrize('average', [False, True])
def test_laplacian_loss(average, rng):
    v, f, x = mesh_and_batch(rng)
    lj = jr.LaplacianLoss(v, f, average=average)
    lt = jt.LaplacianLoss(v, f, average=average)
    assert (lt.nv, lt.nf) == (lj.nv, lj.nf)
    np.testing.assert_array_equal(lt.laplacian.numpy(), np.asarray(lj.laplacian))
    xt = torch.tensor(x, requires_grad=True)
    out = lt(xt)
    assert_close(out.detach().numpy(), np.asarray(lj(jnp.asarray(x))))
    assert out.shape == (() if average else (3,))
    out.sum().backward()
    assert_close(xt.grad.numpy(), np.asarray(jax.grad(lambda a: jnp.sum(lj(a)))(jnp.asarray(x))))


@pytest.mark.parametrize('average', [False, True])
def test_flatten_loss(average, rng):
    v, f, x = mesh_and_batch(rng)
    lj = jr.FlattenLoss(f, average=average)
    lt = jt.FlattenLoss(f, average=average)
    for name in ('v0s', 'v1s', 'v2s', 'v3s'):
        np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
    assert lt.v0s.numel() > 0 and lt.nf == lj.nf
    xt = torch.tensor(x, requires_grad=True)
    out = lt(xt)
    assert_close(out.detach().numpy(), np.asarray(lj(jnp.asarray(x))))
    out.sum().backward()
    assert_close(xt.grad.numpy(), np.asarray(jax.grad(lambda a: jnp.sum(lj(a)))(jnp.asarray(x))),
                 rtol=1e-3)


def test_flatten_loss_flat_mesh_is_zero():
    """Two coplanar triangles: the dihedral cosine is -1 and the loss 0."""
    f = np.array([[0, 1, 2], [1, 3, 2]])
    v = torch.tensor([[[0., 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]])
    lt = jt.FlattenLoss(f)
    assert lt.v0s.tolist() == [1] and lt.v1s.tolist() == [2]
    assert float(lt(v)) < 1e-5
    bent = v.clone()
    bent[0, 3, 2] = 1.0
    assert float(lt(bent)) > 0.1


def test_neg_iou_loss(rng):
    a = rng.uniform(size=(4, 16, 16)).astype(np.float32)
    b = (rng.uniform(size=(4, 16, 16)) > 0.5).astype(np.float32)
    at = torch.tensor(a, requires_grad=True)
    out = jt.neg_iou_loss(at, torch.tensor(b))
    assert_close(out.item(), float(jr.neg_iou_loss(jnp.asarray(a), jnp.asarray(b))))
    out.backward()
    assert_close(at.grad.numpy(),
                 np.asarray(jax.grad(jr.neg_iou_loss)(jnp.asarray(a), jnp.asarray(b))))
    assert float(jt.neg_iou_loss(torch.tensor(b), torch.tensor(b))) < 1e-6


def test_losses_are_modules_with_buffers():
    v, f = uv_sphere(5, 6)
    lap, flat = jt.LaplacianLoss(v, f), jt.FlattenLoss(f)
    assert isinstance(lap, torch.nn.Module) and isinstance(flat, torch.nn.Module)
    assert set(dict(lap.named_buffers())) == {'laplacian'}
    assert set(dict(flat.named_buffers())) == {'v0s', 'v1s', 'v2s', 'v3s'}
    assert not list(lap.parameters()) and not list(flat.parameters())
    assert lap.double().laplacian.dtype == torch.float64
    # the graph preprocessing: every column is an edge (v0, v1) with the
    # opposite vertices v2 and v3 of two faces that share it
    triangles = {frozenset(int(i) for i in t) for t in f}
    quads = tlosses.flatten_edges(f)
    assert quads.shape[0] == 4 and quads.shape[1] > 0
    for a, b, c, d in quads.T.tolist():
        assert c != d and {a, b, c} in triangles and {a, b, d} in triangles
    L = tlosses.laplacian_matrix(v.shape[0], f)
    np.testing.assert_allclose(np.diag(L), 1.0)
    np.testing.assert_allclose(L.sum(1), 0.0, atol=1e-6)


def test_copy_loss_state(rng):
    v, f, x = mesh_and_batch(rng)
    v2, f2 = uv_sphere(4, 5)
    for lj, lt in ((jr.LaplacianLoss(v, f, average=True), jt.LaplacianLoss(v2, f2)),
                   (jr.FlattenLoss(f, average=True), jt.FlattenLoss(f2))):
        convert.copy_loss_state(lj, lt)
        assert lt.average is True
        assert_close(lt(torch.tensor(x)).numpy(), np.asarray(lj(jnp.asarray(x))))
        assert 'laplacian' in dict(lt.named_buffers()) or 'v3s' in dict(lt.named_buffers())
    with pytest.raises(TypeError):
        convert.copy_loss_state(jr.FlattenLoss(f), torch.nn.Identity())


def test_build_vertices_and_params_roundtrip(rng):
    v, f = uv_sphere(6, 7)
    v0 = (v * 0.5)[None].astype(np.float32)
    params = {'displace': rng.normal(scale=0.1, size=v0.shape).astype(np.float32),
              'center': rng.normal(scale=0.1, size=(1, 1, 3)).astype(np.float32)}

    def build_vertices_jax(p):          # demos/demo2-deform.py:61-66
        base = jnp.log(jnp.abs(v0) / (1 - jnp.abs(v0)))
        centroid = jnp.tanh(p['center'])
        vv = jax.nn.sigmoid(base + p['displace']) * jnp.sign(v0)
        vv = jax.nn.relu(vv) * (1 - centroid) - jax.nn.relu(-vv) * (centroid + 1)
        return vv + centroid

    model = deform.DeformModel(v0, f)
    assert float(model.displace.detach().abs().max()) == 0 and model.center.shape == (1, 1, 3)
    # at zero parameters the template comes back
    np.testing.assert_allclose(model.vertices().detach().numpy(), v0, atol=1e-6)
    convert.load_deform_params(model, params)
    back = convert.deform_params(model)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    np.testing.assert_allclose(model.vertices().detach().numpy(),
                               np.asarray(build_vertices_jax(params)), atol=1e-6)
    assert {n for n, _ in model.named_parameters()} == {'displace', 'center'}
