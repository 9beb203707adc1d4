"""The port's N3MR rasterizer against jrender_tpu, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions
(``jrender_tpu.ops.n3mr``) and the port's plain PyTorch versions
(``device='cpu'``).  Where the JAX function reaches a Pallas kernel it
runs in interpret mode, as tests/test_n3mr.py runs it, or the JAX side is
forced to its XLA path with ``api.set_backend('jax')``.

Tolerances, and why:

* z-buffer maps: ``face_index`` equal; depth atol 1e-4, weight atol 5e-4,
  ``face_inv`` atol 1e-3 (tests/test_n3mr.py:285-293: XLA contracts
  a*b + c*d into FMAs, PyTorch rounds every operation) plus rtol 2e-5:
  a sliver's inverse has entries of a few hundred, whose float32 ulp is
  past that atol.  On the soups here
  no winner differs.  On a connected mesh a pixel centre can lie within an
  ulp of a shared edge, where the two faces' depths differ in the last
  bits and either side may pick either face: the renderer tests allow 1%
  of pixels beyond the tolerance (read so far: none).
* images: atol 1e-4 (tests/test_n3mr.py:309-311).
* texture and depth gradients: atol 2e-5 * max|ref| (tests/test_n3mr.py:
  338-340).
* edge gradients: atol 1e-3 * max|ref|.  The JAX suite holds its two XLA
  versions to 2e-5 * max (tests/test_n3mr.py:196-198), which XLA compiles
  to the same contracted arithmetic.  A term is diff / (base / den +- eps)
  with base near 0 beside the edge, so float32 rounding of the crossing is
  amplified by 1 / eps: evaluated in float64, the port's sweep is 2e-5 to
  4e-4 of the scale away from BOTH float32 results, which are as far from
  each other.  ``test_backward_pixel_map_matches_jax`` checks exactly that:
  the port is no further from the float64 value than the JAX oracle is,
  within a factor of 3.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jrender_tpu as jr
import jrender_tpu_torch as jt
from jrender_tpu.ops.n3mr import api as japi
from jrender_tpu.ops.n3mr import banded_bwd
from jrender_tpu.ops.n3mr import impl as jimpl
from jrender_tpu_torch import convert
from jrender_tpu_torch.ops.n3mr import api as tapi
from jrender_tpu_torch.ops.n3mr import cuda_impl as tcuda
from jrender_tpu_torch.ops.n3mr import torch_impl as timpl

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from bench import uv_sphere  # noqa: E402

torch.set_num_threads(2)

EDGE_TOL = 1e-3      # edge gradient, of max|ref| (module docstring)
SUM_TOL = 2e-5       # texture and depth gradients, of max|ref|
PIXEL_FRAC = 0.01    # connected meshes: share of pixels allowed beyond atol


@pytest.fixture()
def jax_xla_backend():
    """Force the JAX package's z-buffer to its XLA path for one test."""
    japi.set_backend('jax')
    try:
        yield
    finally:
        japi.set_backend('auto')


def soup(seed, F, B=1, shrink=1.0, z=(1.2, 4.0)):
    """Random triangles in front of the camera, [B,F,9] float32."""
    rng = np.random.RandomState(seed)
    tri = rng.uniform(-0.95, 0.95, size=(B, F, 3, 2))
    ctr = tri.mean(2, keepdims=True)
    tri = ctr + (tri - ctr) * shrink
    zz = rng.uniform(*z, size=(B, F, 3, 1))
    return np.concatenate([tri, zz], -1).astype(np.float32).reshape(B, F, 9)


def textures_for(seed, B, F, ts):
    return np.random.RandomState(seed).rand(B, F, ts, ts, ts, 3).astype(np.float32)


def T(x):
    return torch.tensor(np.asarray(x))


def tri(z=2.0, reverse=False):
    # n3mr draws this winding; SoftRas' front side is the other one
    fv = np.array([[[-0.7, -0.7, z], [0.7, -0.7, z], [0.0, 0.7, z]]], np.float32)
    if reverse:
        fv = fv[:, ::-1, :].copy()
    return fv[None]  # [1,1,3,3]


def scaled_close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def mostly_close(got, ref, atol, frac=PIXEL_FRAC, pixel_axis=None):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    bad = np.abs(got - ref) > atol
    if pixel_axis is not None:
        bad = bad.any(axis=pixel_axis)
    assert bad.mean() <= frac, f'{bad.mean():.4f} of pixels beyond {atol}'


# ---- the z-buffer -----------------------------------------------------------

@pytest.mark.parametrize('seed,F,B,shrink', [(3, 40, 1, 0.35), (7, 150, 1, 0.35),
                                             (11, 60, 2, 1.0)])
def test_forward_maps_match_jax(seed, F, B, shrink):
    from jrender_tpu.ops.n3mr.pallas_impl import forward_maps_pallas
    face = soup(seed, F, B, shrink, z=(1.5, 3.5))
    is_ = 64
    fi, wt, dp, finv, zc = timpl.forward_maps(T(face), is_, 0.1, 100.0)
    assert fi.dtype == torch.int32 and int((fi >= 0).sum()) > 50
    ref_xla = jax.vmap(lambda f: jimpl.forward_maps_single(f, is_, 0.1, 100.0))(
        jnp.asarray(face))
    ref_pallas = forward_maps_pallas(jnp.asarray(face), is_, 0.1, 100.0)
    for ref in (ref_xla, ref_pallas):
        np.testing.assert_array_equal(fi.numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(dp.numpy(), np.asarray(ref[2]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(wt.numpy(), np.asarray(ref[1]), atol=5e-4)
        np.testing.assert_allclose(finv.numpy(), np.asarray(ref[3]), atol=1e-3, rtol=2e-5)
    # the winner's corner depths, 1 where no face was drawn
    m = fi.numpy() >= 0
    b = np.nonzero(m)[0]
    np.testing.assert_array_equal(zc.numpy()[m], face[b, fi.numpy()[m]][:, 2::3])
    assert (zc.numpy()[~m] == 1.0).all() and (dp.numpy()[~m] == 100.0).all()


def test_forward_maps_on_a_pixel_sample():
    face = T(soup(5, 80, 2))
    whole = timpl.forward_maps(face, 48, 0.1, 100.0, face_chunk=32)
    px = torch.tensor(np.random.RandomState(0).randint(0, 48 * 48, 200))
    some = timpl.forward_maps(face, 48, 0.1, 100.0, pixels=px)
    for w, s in zip(whole, some):
        assert torch.equal(w.reshape(2, 48 * 48, *w.shape[3:])[:, px], s)


def test_degenerate_and_nan_faces_win_no_pixel():
    face = soup(9, 20)
    face[0, 3, 3:] = np.tile(face[0, 3, :3], 2)      # three equal corners
    face[0, 4, 0::3] = [-0.5, 0.0, 0.5]              # collinear, exactly
    face[0, 4, 1::3] = [-0.5, 0.0, 0.5]
    face[0, 5, 2] = np.nan
    fi, wt, dp, finv, zc = timpl.forward_maps(T(face), 64, 0.1, 100.0)
    assert not np.isin(fi.numpy(), [3, 4, 5]).any()
    assert all(torch.isfinite(m).all() for m in (wt, dp, finv, zc))
    rest = np.delete(face, [3, 4, 5], axis=1)
    fi_rest = timpl.forward_maps(T(rest), 64, 0.1, 100.0)[0]
    assert torch.equal(fi >= 0, fi_rest >= 0)


def test_depth_ties_go_to_the_lowest_face_id():
    one = tri()[0].reshape(1, 1, 9)
    face = T(np.concatenate([one] * 5, axis=1))
    for chunk in (512, 2):
        fi = timpl.forward_maps(face, 32, 0.1, 100.0, face_chunk=chunk)[0]
        assert set(np.unique(fi.numpy())) == {-1, 0}


# ---- the rasterizer's functions ---------------------------------------------

@pytest.mark.parametrize('anti_aliasing', [False, True])
@pytest.mark.parametrize('ts', [1, 2, 4])
def test_rasterize_rgbad_matches_jax(ts, anti_aliasing, jax_xla_backend):
    F = 60
    face = soup(11 + ts, F).reshape(1, F, 3, 3)
    tex = textures_for(1, 1, F, ts)
    kw = dict(image_size=32, anti_aliasing=anti_aliasing,
              background_color=(0.1, 0.2, 0.3), eps=1e-3)
    want = japi.rasterize_rgbad(jnp.asarray(face), jnp.asarray(tex), **kw)
    got = tapi.rasterize_rgbad(face, tex, device='cpu', **kw)
    assert got['rgb'].shape == (1, 3, 32, 32) and got['alpha'].shape == (1, 32, 32)
    for k in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4)


def test_rasterize_rgbad_against_the_pallas_backend():
    F = 60
    face = soup(11, F, shrink=0.35).reshape(1, F, 3, 3)
    tex = textures_for(1, 1, F, 2)
    japi.set_backend('pallas')
    try:
        want = japi.rasterize_rgbad(jnp.asarray(face), jnp.asarray(tex), image_size=64,
                                    anti_aliasing=False)
    finally:
        japi.set_backend('auto')
    got = tapi.rasterize_rgbad(face, tex, image_size=64, anti_aliasing=False, device='cpu')
    for k in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4)


def test_outputs_not_asked_for_are_none():
    fv = tri()
    assert tapi.rasterize(fv, np.ones((1, 1, 2, 2, 2, 3), np.float32), 16,
                          device='cpu').shape == (1, 3, 16, 16)
    out = tapi.rasterize_rgbad(fv, None, 16, return_rgb=False, return_depth=False,
                               device='cpu')
    assert out['rgb'] is None and out['depth'] is None
    assert out['alpha'].shape == (1, 16, 16)


def port_grads(fn, face, tex=None):
    f_t = torch.tensor(face, requires_grad=True)
    t_t = None if tex is None else torch.tensor(tex, requires_grad=True)
    fn(f_t, t_t).backward()
    return f_t.grad, None if tex is None else t_t.grad


@pytest.mark.parametrize('ts,anti_aliasing', [(2, False), (4, False), (1, False), (2, True)])
def test_rasterize_gradients_match_jax(ts, anti_aliasing, jax_xla_backend):
    F, is_ = 60, 32
    face = soup(21 + ts, F).reshape(1, F, 3, 3)
    tex = textures_for(2, 1, F, ts)
    w = np.random.RandomState(3).randn(1, 3, is_, is_).astype(np.float32)
    kw = dict(image_size=is_, anti_aliasing=anti_aliasing, eps=1e-3)
    gj = jax.grad(lambda f, t: jnp.sum(japi.rasterize(f, t, **kw) * w), argnums=(0, 1))(
        jnp.asarray(face), jnp.asarray(tex))
    gf, gt = port_grads(lambda f, t: (tapi.rasterize(f, t, device='cpu', **kw) * T(w)).sum(),
                        face, tex)
    scaled_close(gf, gj[0], EDGE_TOL)
    scaled_close(gt, gj[1], SUM_TOL)
    assert (gf.numpy()[..., 2] == 0).all()        # rgb sends nothing to z


@pytest.mark.parametrize('anti_aliasing', [False, True])
def test_silhouette_gradients_match_jax(anti_aliasing, jax_xla_backend):
    F, is_ = 50, 32
    face = soup(31, F).reshape(1, F, 3, 3)
    w = np.random.RandomState(4).randn(1, is_, is_).astype(np.float32)
    kw = dict(image_size=is_, anti_aliasing=anti_aliasing)
    gj = jax.grad(lambda f: jnp.sum(japi.rasterize_silhouettes(f, **kw) * w))(
        jnp.asarray(face))
    gf, _ = port_grads(lambda f, t: (tapi.rasterize_silhouettes(f, device='cpu', **kw)
                                     * T(w)).sum(), face)
    scaled_close(gf, gj, EDGE_TOL)


def test_depth_gradients_match_jax(jax_xla_backend):
    F, is_ = 50, 32
    face = soup(41, F).reshape(1, F, 3, 3)
    w = np.random.RandomState(5).randn(1, is_, is_).astype(np.float32)
    kw = dict(image_size=is_, anti_aliasing=False)
    gj = jax.grad(lambda f: jnp.sum(japi.rasterize_depth(f, **kw) * w))(jnp.asarray(face))
    gf, _ = port_grads(lambda f, t: (tapi.rasterize_depth(f, device='cpu', **kw)
                                     * T(w)).sum(), face)
    scaled_close(gf, gj, SUM_TOL)
    assert np.abs(gf.numpy()[..., 2]).max() > 0


def test_rgbad_gradients_match_jax(jax_xla_backend):
    """All three outputs at once: the edge pass with rgb and alpha, the
    texture gradient and the depth gradient, B = 2."""
    F, is_ = 40, 32
    face = soup(51, F, B=2).reshape(2, F, 3, 3)
    tex = textures_for(6, 2, F, 2)
    rng = np.random.RandomState(7)
    w = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ('rgb', (2, 3, is_, is_)), ('alpha', (2, is_, is_)), ('depth', (2, is_, is_)))}
    kw = dict(image_size=is_, anti_aliasing=False, eps=1e-3)

    def loss_j(f, t):
        out = japi.rasterize_rgbad(f, t, **kw)
        return sum(jnp.sum(out[k] * w[k]) for k in w)

    def loss_t(f, t):
        out = tapi.rasterize_rgbad(f, t, device='cpu', **kw)
        return sum((out[k] * T(w[k])).sum() for k in w)

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(face), jnp.asarray(tex))
    gf, gt = port_grads(loss_t, face, tex)
    scaled_close(gf, gj[0], EDGE_TOL)
    scaled_close(gt, gj[1], SUM_TOL)


# ---- the backward's parts, on the same maps ---------------------------------

def edge_scene(seed=7, F=60, is_=64):
    """The scene of tests/test_n3mr.py TestBandedBackward, maps from JAX."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.95, 0.95, size=(F, 3, 2)).astype(np.float32)
    z = rng.uniform(1.2, 4.0, size=(F, 3, 1)).astype(np.float32)
    face = jnp.asarray(np.concatenate([xy, z], -1).reshape(F, 9))
    fi, wt, dp, _ = jimpl.forward_maps_single(face, is_, 0.1, 100.0)
    alpha = (fi >= 0).astype(jnp.float32)
    tex = jnp.asarray(rng.rand(F, 2, 2, 2, 3).astype(np.float32))
    rgb, zc = jimpl.trilinear_rgb_from_maps(face, tex, fi, wt, dp, 1e-3)
    ga = jnp.asarray(rng.randn(is_, is_).astype(np.float32))
    gr = jnp.asarray(rng.randn(is_, is_, 3).astype(np.float32))
    return face, fi, rgb, alpha, gr, ga, is_, (wt, dp, zc, tex)


@pytest.mark.parametrize('rr,ra', [(True, True), (True, False), (False, True)])
def test_backward_pixel_map_matches_jax(rr, ra):
    face, fi, rgb, alpha, gr, ga, is_, _ = edge_scene()
    args = [T(a)[None] for a in (face, fi, rgb, alpha, gr, ga)]
    got = timpl.backward_pixel_map(*args, is_, 1e-3, rr, ra)[0].numpy()
    oracle = np.asarray(jimpl.backward_pixel_map_single(
        face, fi, rgb, alpha, gr, ga, is_, 1e-3, rr, ra))
    banded = np.asarray(banded_bwd.backward_pixel_map_banded(
        face, fi, rgb, alpha, gr, ga, is_, 1e-3, rr, ra)).reshape(oracle.shape)
    scaled_close(got, oracle, EDGE_TOL)
    scaled_close(got, banded, EDGE_TOL)
    assert (got[:, 2::3] == 0).all()
    # float64: the port is about as far from it as the JAX oracle is
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    exact = timpl.backward_pixel_map(*a64, is_, 1e-3, rr, ra)[0].numpy()
    scale = np.abs(exact).max()
    err_port = np.abs(got - exact).max() / scale
    err_jax = np.abs(oracle - exact).max() / scale
    assert err_port < EDGE_TOL and err_port < 3 * err_jax + 2e-5


def test_backward_pixel_map_on_a_sample_of_faces():
    face, fi, rgb, alpha, gr, ga, is_, _ = edge_scene(seed=3, F=40, is_=48)
    args = [T(a)[None] for a in (face, fi, rgb, alpha, gr, ga)]
    whole = timpl.backward_pixel_map(*args, is_, 1e-3, True, True)
    ids = [5, 0, 17, 33]
    some = timpl.backward_pixel_map(*args, is_, 1e-3, True, True, faces=ids, face_chunk=3)
    assert some.shape == (1, 4, 9)
    np.testing.assert_allclose(some.numpy(), whole[:, ids].numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize('ts', [1, 2, 4])
def test_backward_textures_matches_jax(ts):
    face, fi, rgb, alpha, gr, ga, is_, (wt, dp, zc, _) = edge_scene(seed=5, F=30)
    F = face.shape[0]
    want = np.asarray(jimpl.backward_textures_single((F, ts, ts, ts, 3), fi, wt, dp, zc,
                                                     gr, 1e-3))
    got = timpl.backward_textures((1, F, ts, ts, ts, 3), *(T(a)[None] for a in (
        fi, wt, dp, zc, gr)), 1e-3, pixel_chunk=1000)
    scaled_close(got[0], want, SUM_TOL)


def test_trilinear_fetch_matches_jax():
    face, fi, rgb, alpha, gr, ga, is_, (wt, dp, zc, tex) = edge_scene(seed=5, F=30)
    got = timpl.trilinear_rgb_from_maps(T(tex)[None], *(T(a)[None] for a in (
        fi, wt, dp, zc)), 1e-3, pixel_chunk=1000)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(rgb), atol=2e-6)


def test_backward_depth_matches_jax():
    face, fi, rgb, alpha, gr, ga, is_, (wt, dp, zc, _) = edge_scene(seed=5, F=30)
    finv = jimpl.forward_maps_single(face, is_, 0.1, 100.0)[3]
    want = np.asarray(jimpl.backward_depth_single(face, fi, finv, wt, dp, zc, ga))
    got = timpl.backward_depth(*(T(a)[None] for a in (face, fi, finv, wt, dp, zc, ga)))
    scaled_close(got[0], want, SUM_TOL)


def test_wrappers_go_by_the_device():
    """A CPU tensor takes the plain version; a kernel's wrapper refuses it."""
    face = T(soup(1, 10))
    rows, fi, wt, dp, finv, zc, rgb = tcuda.forward_maps(face, None, 32, 0.1, 100.0, 1e-3)
    assert rgb is None and rows.shape == (1, 10, timpl.ROW)
    assert torch.equal(fi, timpl.forward_maps(face, 32, 0.1, 100.0)[0])
    with pytest.raises(ValueError, match='CUDA'):
        tcuda.launch_maps(rows, None, None, 32, 0.1, 100.0, 1e-3)
    pp, fi2, planes = tcuda.edge_inputs(face, fi, None, (fi >= 0).float(), None,
                                        torch.ones(1, 32, 32), 32, False, True)
    assert pp.shape == (1, 10, 7)
    with pytest.raises(ValueError, match='CUDA'):
        tcuda.launch_edgebwd(pp, fi2, planes, 1e-3, False, True)
    with pytest.raises(ValueError, match='CUDA'):
        tcuda.launch_texbwd(rows, (1, 10, 2, 2, 2, 3), fi, wt, dp, zc, None, 1e-3)
    assert tcuda.launch_maps.launches == 0 and tcuda.launch_texbwd.launches == 0 \
        and tcuda.launch_edgebwd.launches == 0


def test_edge_inputs_layout():
    rng = np.random.RandomState(0)
    face = T(soup(1, 4, B=2))
    fi = T(rng.randint(-1, 5, (2, 6, 6)).astype(np.int32))
    rgb, gr = T(rng.rand(2, 6, 6, 3)), T(rng.rand(2, 6, 6, 3))
    al, ga = T(rng.rand(2, 6, 6)), T(rng.rand(2, 6, 6))

    def edge_planes(rr, ra):
        return tcuda.edge_inputs(face, fi, rgb, al, gr, ga, 6, rr, ra)[1:]

    pp = tcuda.edge_inputs(face, fi, rgb, al, gr, ga, 6, True, True)[0]
    np.testing.assert_allclose(pp[1, 2, 2:4].numpy(), 0.5 * (face[1, 2, 3:5].numpy() * 6 + 5))
    assert torch.equal(pp[..., 6] > 0.5, timpl._face_frontside_n3mr(face))
    fi2, planes = edge_planes(True, True)
    assert fi2.shape == (2, 2, 6, 6) and planes.shape == (2, 2, 8, 6, 6)
    assert fi2.is_contiguous() and planes.is_contiguous()
    assert torch.equal(fi2[0, 1, 2, 5], fi[1, 5, 2]) and torch.equal(fi2[1], fi)
    assert torch.equal(planes[1, :, 0], al) and torch.equal(planes[0, :, 1, 3, 4], ga[:, 4, 3])
    assert torch.equal(planes[1, :, 2:5], rgb.permute(0, 3, 1, 2))
    assert torch.equal(planes[0, 0, 7, 1, 2], gr[0, 2, 1, 2])
    assert edge_planes(True, False)[1].shape[2] == 6
    assert edge_planes(False, True)[1].shape[2] == 2


def test_edge_scan_census_counts_the_sweep():
    """The census of the bound counts the cells of the plane sweep's own
    ranges: a lone triangle's OUT scans reach the border from each edge."""
    face = T(tri()[0].reshape(1, 1, 9))
    fi = timpl.forward_maps(face, 32, 0.1, 100.0)[0]
    rows, out_cells, in_cells, longest, positive = timpl.edge_scan_census(face, fi, 32)
    assert rows > 0 and out_cells > 0 and in_cells > 0 and positive is None
    assert longest <= out_cells + in_cells and in_cells <= 6 * int((fi >= 0).sum())
    back = T(tri(reverse=True)[0].reshape(1, 1, 9))
    assert timpl.edge_scan_census(back, fi, 32) == (0, 0, 0, 0, None)
    # cells with a positive difference, on the silhouette and a gradient of
    # one sign: falling alpha is positive on every cell outside the triangle
    # (all of the OUT scans) and on none of its own, rising alpha the reverse
    alpha = (fi[0] >= 0).float()
    own = int(alpha.sum())
    falling = timpl.edge_scan_census(face, fi, 32, [[(alpha, -torch.ones_like(alpha))]])
    rising = timpl.edge_scan_census(face, fi, 32, [[(alpha, torch.ones_like(alpha))]])
    assert falling[:4] == (rows, out_cells, in_cells, longest)
    assert falling[4] == out_cells and 0 < rising[4] <= min(in_cells, 6 * own)
    assert timpl.edge_scan_census(face, fi, 32, [[(alpha, torch.zeros_like(alpha))]])[4] == 0


# ---- the module facade and the Renderer -------------------------------------

def sphere_meshes(ts=2, seed=0):
    v, f = uv_sphere(13, 12)
    tex = np.random.RandomState(seed).uniform(size=(1, f.shape[0], ts, ts, ts, 3)) \
        .astype(np.float32)
    mj = jr.Mesh(v, f, textures=tex, texture_res=ts, dr_type='n3mr')
    return mj, convert.mesh_from_numpy(convert.mesh_arrays(mj), device='cpu')


def both_renderers(az, **kw):
    rj = jr.Renderer(dr_type='n3mr', **kw)
    rj.transform.set_eyes_from_angles(2.732, 30, az)
    rt = jt.Renderer(dr_type='n3mr', device='cpu', **kw)
    convert.copy_renderer_state(rj, rt)
    return rj, rt


def test_convert_keeps_dr_type():
    mj, mt = sphere_meshes(ts=4)
    assert mt.dr_type == 'n3mr' and mt.texture_res == 4
    assert mt.textures.shape == mj.textures.shape
    assert mt.metallic_textures.shape == (1, mt.num_faces, 4, 4, 4, 1)
    again = convert.mesh_from_numpy(convert.mesh_arrays(mt), device='cpu')
    assert again.dr_type == 'n3mr'
    ms = jr.Mesh(*uv_sphere(13, 12))
    assert convert.mesh_from_numpy(convert.mesh_arrays(ms), device='cpu').dr_type == 'softras'


@pytest.mark.parametrize('mode', [None, 'rgb', 'silhouettes', 'depth'])
@pytest.mark.parametrize('fill_back', [True, False])
def test_n3mr_rasterizer_modes_match_jax(mode, fill_back, jax_xla_backend):
    rng = np.random.RandomState(2)
    V, F = 30, 40
    verts = np.concatenate([rng.uniform(-0.9, 0.9, (1, V, 2)),
                            rng.uniform(1.5, 3.5, (1, V, 1))], -1).astype(np.float32)
    faces = rng.randint(0, V, (1, F, 3))
    tex = textures_for(3, 1, F, 2)
    kw = dict(image_size=32, anti_aliasing=True, background_color=(0.3, 0.2, 0.1),
              fill_back=fill_back)
    want = japi.N3mrRasterizer(**kw)(
        jr.Mesh(verts, faces, textures=tex, texture_res=2, dr_type='n3mr'), mode)
    got = tapi.N3mrRasterizer(device='cpu', **kw)(
        jt.Mesh(verts, faces, textures=tex, texture_res=2, dr_type='n3mr', device='cpu'), mode)
    if mode is None:
        assert len(got) == 3
    else:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    with pytest.raises(ValueError):
        tapi.N3mrRasterizer(device='cpu')(jt.Mesh(verts, faces, device='cpu'), 'normal')


@pytest.mark.parametrize('mode,az', [('rgb', 0), ('rgb', 135), ('silhouettes', 45),
                                     ('depth', 250), (None, 90)])
def test_render_mesh_n3mr_matches_jax(mode, az, jax_xla_backend):
    rj, rt = both_renderers(az, image_size=32, anti_aliasing=True)
    mj, mt = sphere_meshes(seed=az)
    want = rj.render_mesh(mj, mode=mode)
    got = rt.render_mesh(mt, mode=mode)
    if mode is not None:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert float(g.abs().mean()) > 0.01
        mostly_close(g.numpy(), np.asarray(w), 1e-4, pixel_axis=1 if g.dim() == 4 else None)
    # render_mesh rewrites the mesh like the reference: lit 6-D textures
    np.testing.assert_allclose(mt.textures.numpy(), np.asarray(mj.textures), atol=1e-6)


def test_render_mesh_n3mr_vertex_light_mode():
    """The 6-dimensional texture branch of the vertex light mode."""
    mj, mt = sphere_meshes()
    lj = jr.Lighting(light_mode='surface', intensity_directionals=0.7)
    lt = jt.Lighting(light_mode='surface', intensity_directionals=0.7)
    np.testing.assert_allclose(lt(mt).textures.numpy(), np.asarray(lj(mj).textures), atol=1e-6)


def test_render_mesh_n3mr_gradients_match_jax(jax_xla_backend):
    """Vertices and textures through lighting, transform, fill_back and the
    rasterizer, demo 4's lighting (ambient only)."""
    kw = dict(image_size=32, anti_aliasing=False, camera_mode='look_at',
              light_intensity_directionals=0.0, light_intensity_ambient=1.0)
    rj, rt = both_renderers(60, **kw)
    v, f = uv_sphere(13, 12)
    tex = np.random.RandomState(8).uniform(0.1, 0.9, (1, f.shape[0], 2, 2, 2, 3)) \
        .astype(np.float32)
    w = np.random.RandomState(9).randn(1, 3, 32, 32).astype(np.float32)

    def loss_j(vv, tt):
        m = jr.Mesh(vv, f, textures=tt, texture_res=2, dr_type='n3mr')
        return jnp.sum(rj.render_mesh(m, mode='rgb') * w)

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v)[None], jnp.asarray(tex))
    v_t = torch.tensor(v[None], requires_grad=True)
    t_t = torch.tensor(tex, requires_grad=True)
    m = jt.Mesh(v_t, f, textures=t_t, texture_res=2, dr_type='n3mr', device='cpu')
    (rt.render_mesh(m, mode='rgb') * T(w)).sum().backward()
    # near-tie pixels on shared edges may go to either face (module docstring)
    from jrender_tpu_torch.utils.checks import grad_beyond
    share_v, err_v = grad_beyond(v_t.grad, np.asarray(gj[0]))
    share_t, err_t = grad_beyond(t_t.grad, np.asarray(gj[1]))
    assert share_v <= 0.01 and share_t <= 0.01, (share_v, err_v, share_t, err_t)
    assert v_t.grad.abs().max() > 0 and t_t.grad.abs().max() > 0


# ---- behaviour, on the port alone (tests/test_n3mr.py:22-167) ---------------

def test_silhouette_of_one_triangle():
    s = tapi.rasterize_silhouettes(tri(), 32, anti_aliasing=False, device='cpu').numpy()
    assert s.shape == (1, 32, 32)
    assert s[0, 16, 16] == 1.0 and s[0, 0, 0] == 0.0 and 0.05 < s.mean() < 0.6


def test_depth_and_far_background():
    d = tapi.rasterize_depth(tri(z=3.0), 32, anti_aliasing=False, device='cpu').numpy()
    assert abs(d[0, 16, 16] - 3.0) < 1e-4 and d[0, 0, 0] == 100.0


def test_depth_ordering_and_flat_texture():
    fv = np.concatenate([tri(z=5.0), tri(z=2.0)], axis=1)
    tex = np.zeros((1, 2, 2, 2, 2, 3), np.float32)
    tex[0, 0, ..., 2] = 1.0     # far: blue
    tex[0, 1, ..., 0] = 0.7     # near: red
    img = tapi.rasterize(fv, tex, 32, anti_aliasing=False, device='cpu').numpy()
    np.testing.assert_allclose(img[0, :, 16, 16], [0.7, 0, 0], atol=1e-5)


def test_backface_culled():
    s = tapi.rasterize_silhouettes(tri(reverse=True), 32, anti_aliasing=False, device='cpu')
    assert s.max() == 0.0


def test_anti_aliasing_softens_edges():
    s = tapi.rasterize_silhouettes(tri(), 32, anti_aliasing=True, device='cpu').numpy()
    assert s.shape == (1, 32, 32) and ((s > 0) & (s < 1)).any()


def test_silhouette_gradient_points_outward_and_spares_z():
    fv = tri()
    x = torch.tensor(fv, requires_grad=True)
    tapi.rasterize_silhouettes(x, 64, anti_aliasing=False, device='cpu').sum().backward()
    g = x.grad.numpy()[0, 0]
    assert np.isfinite(g).all() and (g[:, 2] == 0).all()
    centroid = fv[0, 0, :, :2].mean(0)
    for k in range(3):
        outward = fv[0, 0, k, :2] - centroid
        assert np.dot(g[k, :2], outward / np.linalg.norm(outward)) > 0


def test_texture_gradient_is_the_sampling_weight():
    fv = tri()

    def loss(t):
        return tapi.rasterize(fv, t, 32, anti_aliasing=False, device='cpu').sum()

    tex = torch.full((1, 1, 2, 2, 2, 3), 0.5, requires_grad=True)
    loss(tex).backward()
    g = tex.grad
    assert torch.isfinite(g).all() and g.sum() > 0
    fd = (loss(tex.detach() + 0.01) - loss(tex.detach())).item() / 0.01
    np.testing.assert_allclose(fd, g.sum().item(), rtol=1e-2)


def test_autograd_never_differentiates_the_forward():
    """No graph hangs off the maps: the only path to the inputs is the
    Function's own backward."""
    x = torch.tensor(tri(), requires_grad=True)
    out = tapi.rasterize_rgbad(x, None, 16, anti_aliasing=False, return_rgb=False,
                               device='cpu')
    assert out['alpha'].grad_fn is not None
    node = out['depth'].grad_fn
    while node is not None and 'N3mrRasterizeCore' not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None
