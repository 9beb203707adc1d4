"""The port's render path against jrender_tpu, on the CPU.

``jrender_tpu_torch.Renderer(device='cpu').render_mesh`` against
``jrender_tpu.Renderer(backend='jax')`` on ``bench.py``'s UV sphere with
seeded textures, forward and gradients, demo 2's training step, and the
parts one by one: Transform, Lighting, Mesh.  The scene and the training
state go across with ``jrender_tpu_torch.convert``.

Image tolerances are those of test_torch_softras.py, knife edges
included (``assert_rgb_close``): here the sphere's pole rows are slivers
seen obliquely, and the default sigma = 1e-5 and gamma = 1e-4 amplify an
ulp of a vertex or a depth into a visible change of coverage and blend.
So the float64 reference of a rendered image is the port's rasterizer in
float64 on the inputs that the port's own lighting and transform give
(``port_rgb_float64``); those inputs are held to the JAX package's one by
one below.  Measured over the renders below: up to 2.7% of the rgb
pixels differ beyond the tolerance, at most 0.39% unexplained.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jrender_tpu as jr
import jrender_tpu_torch as jt
from jrender_tpu_torch import convert
from jrender_tpu_torch.ops.softras import make_params, torch_impl
from jrender_tpu_torch.renderer.rasterizer import pool2x_mean
from jrender_tpu_torch.structures import mesh as tmesh

from test_torch_softras import (ATOL, RTOL, assert_close_except_edges, assert_grad_close,
                                assert_rgb_close, fold_ties, texel_tie_variants,
                                tie_symmetric)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from bench import uv_sphere  # noqa: E402

torch.set_num_threads(2)


def sphere(seed=0, R=5):
    v, f = uv_sphere(13, 12)
    rng = np.random.RandomState(seed)
    tex = rng.uniform(size=(1, f.shape[0], R * R, 3)).astype(np.float32)
    return v, f, tex


def both_renderers(az, **kw):
    rj = jr.Renderer(backend='jax', **kw)
    rj.transform.set_eyes_from_angles(2.732, 30, az)
    rt = jt.Renderer(device='cpu', **kw)
    convert.copy_renderer_state(rj, rt)
    return rj, rt


def both_meshes(seed=0, R=5):
    v, f, tex = sphere(seed, R)
    mj = jr.Mesh(v, f, textures=tex, texture_res=R)
    return mj, convert.mesh_from_numpy(convert.mesh_arrays(mj), device='cpu')


def port_rgb_float64(rt, mesh):
    """The port's rgb with its rasterizer's plain version in float64, on the
    float32 inputs that the port's own lighting and transform give."""
    rt.set_texture_mode(mesh.texture_type)
    lit = rt.transform(rt.lighting(mesh, rt.transform.eyes))
    r = rt.rasterizer
    p = make_params(image_size=r.image_size * (2 if r.anti_aliasing else 1),
                    background_color=r.background_color, near=r.near, far=r.far,
                    fill_back=r.fill_back, eps=r.eps, sigma_val=r.sigma_val,
                    dist_func=r.dist_func, dist_eps=r.dist_eps, gamma_val=r.gamma_val,
                    aggr_func_rgb=r.aggr_func_rgb, aggr_func_alpha=r.aggr_func_alpha,
                    texture_type=r.texture_type)
    fv = lit.face_vertices
    img = torch_impl.soft_rasterize_fwd_plain(fv.reshape(fv.shape[0], -1, 9).double(),
                                              lit.face_textures.double(), p)[0]
    if r.anti_aliasing:
        img = pool2x_mean(img)
    return img[:, :3].numpy()


def check_render_rgb(rt, new_mesh, got, want):
    """assert_rgb_close for a rendered image; ``new_mesh()`` makes the
    port's mesh afresh (render_mesh rewrites its textures)."""
    ties = texel_tie_variants(lambda: rt.render_mesh(new_mesh(), mode='rgb'))
    assert_rgb_close(got, want, ties, port_rgb_float64(rt, new_mesh()))


@pytest.mark.parametrize('mode,az', [('rgb', 0), ('rgb', 135), ('silhouettes', 45),
                                     ('silhouettes', 250), (None, 90)])
def test_render_mesh_matches_jax(mode, az):
    rj, rt = both_renderers(az, image_size=64)
    mj, mt = both_meshes(seed=az)
    outj = rj.render_mesh(mj, mode=mode)
    outt = rt.render_mesh(mt, mode=mode)
    if mode is None:
        (aj, cj), (at, ct) = outj, outt
    elif mode == 'rgb':
        aj = at = None
        cj, ct = outj, outt
    else:
        aj, at = outj, outt
        cj = ct = None
    if cj is not None:
        assert ct.shape == (1, 3, 64, 64)
        check_render_rgb(rt, lambda: both_meshes(seed=az)[1], ct.numpy(), np.asarray(cj))
    if aj is not None:
        assert at.shape == (1, 64, 64)
        assert float(at.mean()) > 0.1                 # the sphere is in view
        assert_close_except_edges(at.numpy(), np.asarray(aj), ATOL, RTOL)
    # render_mesh rewrites the mesh like the reference: lit textures
    np.testing.assert_allclose(mt.textures.numpy(), np.asarray(mj.textures), atol=1e-6)


def test_render_mesh_anti_aliasing():
    rj, rt = both_renderers(30, image_size=32, anti_aliasing=True)
    mj, mt = both_meshes(seed=3)
    aj, cj = rj.render_mesh(mj, mode=None)
    at, ct = rt.render_mesh(mt, mode=None)
    assert ct.shape == (1, 3, 32, 32)
    check_render_rgb(rt, lambda: both_meshes(seed=3)[1], ct.numpy(), np.asarray(cj))
    assert_close_except_edges(at.numpy(), np.asarray(aj), ATOL, RTOL)


def test_render_mesh_vertex_colours():
    v, f, _ = sphere()
    tex = np.random.RandomState(4).uniform(size=(1, v.shape[0], 3)).astype(np.float32)
    rj, rt = both_renderers(60, image_size=64)
    aj, cj = rj.render_mesh(jr.Mesh(v, f, textures=tex, texture_type='vertex'), mode=None)
    def new_mesh():
        return jt.Mesh(v, f, textures=tex, texture_type='vertex', device='cpu')

    at, ct = rt.render_mesh(new_mesh(), mode=None)
    check_render_rgb(rt, new_mesh, ct.numpy(), np.asarray(cj))
    assert_close_except_edges(at.numpy(), np.asarray(aj), ATOL, RTOL)


def test_demo1_loop_resets_the_mesh():
    """Demo 1's frame loop: reset_ before each frame gives the same frame."""
    _, rt = both_renderers(20, image_size=32)
    _, mt = both_meshes()
    frames = []
    for _ in range(2):
        mt.reset_()
        frames.append(rt.render_mesh(mt, mode='rgb'))
    torch.testing.assert_close(frames[0], frames[1], rtol=0, atol=0)


# --------------------------------------------------------------------------
# gradients through render_mesh, and demo 2's training step
# --------------------------------------------------------------------------
#
# Gradient tolerance: atol = 2e-3 * max|grad| and rtol = 2e-3, that of
# tests/test_softras_pallas.py:126-128, for every entry (measured: max
# 0.3% of the scale).  The textures are equal on the two
# sides of the texel selector's diagonal tie and their gradients are
# compared folded over each tie pair (see test_torch_softras.py).  K stays
# at the Renderer's 16, which rarely binds on this sphere: on a connected
# mesh the faces around a vertex have the same clipped depth at a pixel
# beyond it, a tie at the K-th place that the oracle's face ids and the
# kernels' threshold resolve differently (test_topk_ties_keep_every_tied_face).

def small_sphere(seed, R):
    v, f = uv_sphere(9, 10)                              # 160 faces
    tex = np.random.RandomState(seed).uniform(size=(1, f.shape[0], R * R, 3))
    return v, f, tie_symmetric(tex.astype(np.float32))


@pytest.mark.parametrize('mode,R,kw', [
    ('rgb', 1, dict(image_size=64)),
    ('silhouettes', 1, dict(image_size=64)),
    (None, 2, dict(image_size=64)),
    (None, 1, dict(image_size=32, anti_aliasing=True)),
    ('rgb', 2, dict(image_size=64, sigma_val=1e-4, gamma_val=1e-3, fill_back=False)),
], ids=['rgb', 'silhouettes', 'both-R2', 'anti-aliasing', 'wide'])
def test_render_mesh_gradients_match_jax(mode, R, kw):
    """d(render_mesh)/d(vertices, textures) through lighting, transform,
    the rasterizer's explicit backward, the anti-aliasing pool and the mode
    slicing, against jax.grad of the JAX package with backend='jax'."""
    import jax
    import jax.numpy as jnp
    v, f, tex = small_sphere(11, R)
    rj, rt = both_renderers(40, **kw)
    is_ = kw['image_size']
    rng = np.random.RandomState(12)
    ga = rng.randn(1, is_, is_).astype(np.float32)
    gc = rng.randn(1, 3, is_, is_).astype(np.float32)

    def weigh(out, xp):
        if mode == 'rgb':
            return xp.sum(out * gc)
        if mode == 'silhouettes':
            return xp.sum(out * ga)
        return xp.sum(out[0] * ga) + xp.sum(out[1] * gc)

    def loss_j(vv, tt):
        return weigh(rj.render_mesh(jr.Mesh(vv, f, textures=tt, texture_res=R), mode=mode), jnp)

    gvj, gtj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(tex))
    vt = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(tex, requires_grad=True)
    mesh = jt.Mesh(vt, f, textures=tt, texture_res=R, device='cpu')
    out = rt.render_mesh(mesh, mode=mode)
    ga, gc = torch.tensor(ga), torch.tensor(gc)
    weigh(out, torch).backward()
    assert vt.grad.shape == v.shape
    assert_grad_close(vt.grad.numpy(), np.asarray(gvj))
    if mode == 'silhouettes':
        # alpha does not depend on the textures
        assert tt.grad is None or float(tt.grad.abs().max()) == 0
        assert float(np.abs(np.asarray(gtj)).max()) == 0
    else:
        assert_grad_close(fold_ties(tt.grad.numpy()), fold_ties(np.asarray(gtj)))
    # reset_ restores the leaves, so the next frame differentiates again
    mesh.reset_()
    assert mesh.vertices.shape == (1,) + v.shape and mesh.textures is tt


def test_gradient_reaches_mesh_leaves_and_vertex_colours():
    """A leaf that requires grad survives Mesh's and soft_rasterize's
    conversions; vertex colours get their gradient through face_textures."""
    v, f, _ = small_sphere(0, 1)
    col = np.random.RandomState(3).uniform(size=(1, v.shape[0], 3)).astype(np.float32)
    vt = torch.tensor(v[None], requires_grad=True)
    ct = torch.tensor(col, requires_grad=True)
    mesh = jt.Mesh(vt, f, textures=ct, texture_type='vertex', device='cpu')
    assert mesh.vertices is vt and mesh.textures is ct
    rt = jt.Renderer(image_size=32, device='cpu', sigma_val=1e-4)
    rt.transform.set_eyes_from_angles(2.732, 20, 60)
    alpha, rgb = rt.render_mesh(mesh, mode=None)
    assert alpha.requires_grad and rgb.requires_grad
    (alpha.sum() + rgb.sum()).backward()
    for g in (vt.grad, ct.grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0
    with torch.no_grad():
        mesh.reset_()
        assert not rt.render_mesh(mesh, mode='rgb').requires_grad


def test_demo2_three_steps_match_jax():
    """Three steps of demo 2's optimisation (demos/demo2-deform.py:49-80)
    in both packages from the same state: 96-face sphere, 4 views at 32 px,
    silhouettes of an ellipsoid as targets, Adam(0.01, betas 0.5, 0.99).
    Adam divides by the gradient's running magnitude, so after three steps
    an entry has moved by about 0.03 whatever its gradient's size, and an
    entry whose gradient is at rounding level can go either way: the
    parameters are held to 2e-3 (a fifteenth of the distance moved) for all
    but 1% of the entries, and the losses to 1e-4."""
    import jax
    import jax.numpy as jnp
    import optax
    from jrender_tpu_torch import deform
    v, f = uv_sphere(7, 8)
    v0 = (v * 0.5)[None].astype(np.float32)
    B = 4
    cams = (np.full(B, 2.732, np.float32), np.array([0, 15, 30, 45], np.float32),
            np.array([10, 100, 190, 280], np.float32))
    kw = dict(image_size=32, sigma_val=1e-4, aggr_func_rgb='hard', camera_mode='look_at',
              viewing_angle=15)
    rj = jr.Renderer(backend='jax', **kw)
    rj.transform.set_eyes_from_angles(*(jnp.asarray(c) for c in cams))
    rt = jt.Renderer(device='cpu', **kw)
    convert.copy_renderer_state(rj, rt)
    faces_j = jnp.asarray(f)[None]
    targets = np.asarray(rj.render_mesh(
        jr.Mesh(jnp.repeat(jnp.asarray(v0 * np.float32([1.4, 0.7, 1.0])), B, 0),
                jnp.repeat(faces_j, B, 0)), mode='silhouettes'))
    assert 0.02 < targets.mean() < 0.9

    lap_j = jr.LaplacianLoss(v0[0], f)
    flat_j = jr.FlattenLoss(f)
    params = {'displace': jnp.zeros(v0.shape), 'center': jnp.zeros((1, 1, 3))}
    optimizer = optax.adam(0.01, b1=0.5, b2=0.99)
    opt_state = optimizer.init(params)

    def build_vertices(p):
        base = jnp.log(jnp.abs(v0) / (1 - jnp.abs(v0)))
        centroid = jnp.tanh(p['center'])
        vv = jax.nn.sigmoid(base + p['displace']) * jnp.sign(v0)
        vv = jax.nn.relu(vv) * (1 - centroid) - jax.nn.relu(-vv) * (centroid + 1)
        return vv + centroid

    def loss_fn(p):
        vv = build_vertices(p)
        sil = rj.render_mesh(jr.Mesh(jnp.repeat(vv, B, 0), jnp.repeat(faces_j, B, 0)),
                             mode='silhouettes')
        return jr.neg_iou_loss(sil, jnp.asarray(targets)) + 0.03 * jnp.mean(lap_j(vv)) \
            + 0.0003 * jnp.mean(flat_j(vv))

    model = deform.DeformModel(v0, f)
    convert.load_deform_params(model, {k: np.asarray(x) for k, x in params.items()})
    convert.copy_loss_state(lap_j, model.laplacian_loss)
    convert.copy_loss_state(flat_j, model.flatten_loss)
    opt_t = torch.optim.Adam(model.parameters(), lr=0.01, betas=(0.5, 0.99))
    tt = torch.tensor(targets)
    losses_j, losses_t = [], []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))
        losses_t.append(float(deform.deform_step(model, opt_t, rt, tt)[0]))
    np.testing.assert_allclose(losses_t, losses_j, atol=1e-4)
    assert losses_t[-1] < losses_t[0]
    got = convert.deform_params(model)
    for name in ('displace', 'center'):
        want = np.asarray(params[name])
        assert np.abs(want).max() > 0.02                  # the parameters moved
        bad = np.abs(got[name] - want) > 2e-3
        assert bad.mean() <= 0.01, f'{name}: {bad.mean():.4f} beyond 2e-3, ' \
            f'max {np.abs(got[name] - want).max():.3g}'


# --------------------------------------------------------------------------
# the parts one by one
# --------------------------------------------------------------------------

@pytest.mark.parametrize('fn', ['look_at', 'look', 'perspective', 'orthogonal',
                                'projection'])
def test_transform_functions(fn, rng):
    v = rng.randn(2, 50, 3).astype(np.float32) * 0.5
    vj, vt = np.asarray(v), torch.tensor(v)
    eye = [0.3, 0.5, -2.5]
    if fn == 'look_at':
        a, b = jr.look_at(vj, eye), jt.look_at(vt, eye)
    elif fn == 'look':
        a = jr.look(vj, eye, direction=(0.1, -0.2, 1.0))
        b = jt.look(vt, eye, direction=(0.1, -0.2, 1.0))
    elif fn == 'perspective':
        v[..., 2] += 3.0
        a, b = jr.perspective(np.asarray(v), 30), jt.perspective(torch.tensor(v), 30)
    elif fn == 'orthogonal':
        a, b = jr.orthogonal(vj, 1.5), jt.orthogonal(vt, 1.5)
    else:
        K = np.array([[[500, 0, 256], [0, 500, 256], [0, 0, 1]]], np.float32).repeat(2, 0)
        R = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
        t = np.array([[[0, 0, 3]]], np.float32).repeat(2, 0)
        d = np.array([[0.01, -0.02, 0.001, 0.002, 0.0]], np.float32).repeat(2, 0)
        a = jr.projection(vj, K, R, t, d)
        b = jt.projection(vt, K, R, t, d)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_transform_module_and_eyes():
    tj = jr.Transform('look_at')
    tt = jt.Transform('look_at')
    tj.set_eyes_from_angles(2.732, 30, 45)
    tt.set_eyes_from_angles(2.732, 30, 45)
    assert tt.eyes == tj.eyes
    v, f, _ = sphere()
    a = tj.tranpos(np.asarray(v)[None])
    b = tt.tranpos(torch.tensor(v)[None])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    eyes = jt.get_points_from_angles(torch.tensor([2.0, 3.0]), torch.tensor([10.0, 20.0]),
                                     torch.tensor([30.0, 40.0]))
    eyes_j = jr.get_points_from_angles(np.array([2.0, 3.0]), np.array([10.0, 20.0]),
                                       np.array([30.0, 40.0]))
    np.testing.assert_allclose(eyes.numpy(), np.asarray(eyes_j), rtol=1e-6)


@pytest.mark.parametrize('light_mode', ['surface', 'vertex'])
def test_lighting(light_mode):
    v, f, tex = sphere(seed=1)
    rng = np.random.RandomState(7)
    if light_mode == 'vertex':
        tex = rng.uniform(size=(1, v.shape[0], 3)).astype(np.float32)
    metal = rng.uniform(size=tex.shape[:-1] + (1,)).astype(np.float32)
    rough = rng.uniform(0.2, 1, size=tex.shape[:-1] + (1,)).astype(np.float32)
    kw = dict(texture_type=light_mode, metallic_textures=metal, roughness_textures=rough)
    mj = jr.Mesh(v, f, textures=tex, texture_res=1 if light_mode == 'vertex' else 5, **kw)
    mt = jt.Mesh(v, f, textures=tex, texture_res=1 if light_mode == 'vertex' else 5,
                 device='cpu', **kw)
    eye = (1.0, 1.2, -2.0)
    lj = jr.Lighting(light_mode, directions=(0.3, 1.0, -0.5))
    lt = jt.Lighting(light_mode, directions=(0.3, 1.0, -0.5))
    lj(mj, eye)
    lt(mt, eye)
    np.testing.assert_allclose(mt.textures.numpy(), np.asarray(mj.textures), atol=2e-6)
    # without the specular term (Lambert only)
    mj.reset_()
    mt.reset_()
    mj.with_specular = False
    mt.with_specular = False
    lj(mj, eye)
    lt(mt, eye)
    np.testing.assert_allclose(mt.textures.numpy(), np.asarray(mj.textures), atol=2e-6)


@pytest.mark.parametrize('gbuffer', ['albedo', 'normal', 'depth'])
def test_lighting_gbuffer(gbuffer):
    """The Renderer's G-buffer debug outputs (reference lighting.py:178-181)."""
    v, f, tex = sphere(seed=2)
    mj = jr.Mesh(v, f, textures=tex, texture_res=5)
    mt = jt.Mesh(v, f, textures=tex, texture_res=5, device='cpu')
    tj, tt = jr.Transform('look_at'), jt.Transform('look_at')
    jr.Lighting(Gbuffer=gbuffer, transform=tj)(mj, tj.eyes)
    jt.Lighting(Gbuffer=gbuffer, transform=tt)(mt, tt.eyes)
    np.testing.assert_allclose(mt.textures.numpy(), np.asarray(mj.textures), atol=2e-6)


def test_lighting_free_function(rng):
    faces = rng.randn(2, 10, 3, 3).astype(np.float32)
    tex = rng.uniform(size=(2, 10, 2, 2, 2, 3)).astype(np.float32)
    a = jr.lighting(faces, tex, direction=(0.0, 0.6, 0.8))
    b = jt.lighting(torch.tensor(faces), torch.tensor(tex), direction=(0.0, 0.6, 0.8))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_mesh_normals_and_faces():
    v, f, tex = sphere()
    mj = jr.Mesh(v, f, textures=tex, texture_res=5)
    mt = jt.Mesh(v, f, textures=tex, texture_res=5, device='cpu')
    np.testing.assert_array_equal(mt.face_vertices.numpy(), np.asarray(mj.face_vertices))
    np.testing.assert_allclose(mt.surface_normals.numpy(), np.asarray(mj.surface_normals),
                               atol=1e-6)
    np.testing.assert_allclose(mt.vertex_normals.numpy(), np.asarray(mj.vertex_normals),
                               atol=1e-6)
    assert mt.texture_res == mj.texture_res == 5
    assert mt.metallic_textures.shape == tuple(mj.metallic_textures.shape)
    torch.testing.assert_close(mt.roughness_textures, torch.ones_like(mt.roughness_textures))


def test_mesh_fill_back_reset_join():
    v, f, tex = sphere()
    mt = jt.Mesh(v, f, textures=tex, texture_res=5, device='cpu')
    mj = jr.Mesh(v, f, textures=tex, texture_res=5)
    mt.fill_back_()
    mj.fill_back_()
    np.testing.assert_array_equal(mt.faces.numpy(), np.asarray(mj.faces))
    np.testing.assert_array_equal(mt.textures.numpy(), np.asarray(mj.textures))
    mt.reset_()
    mj.reset_()
    assert mt.num_faces == f.shape[0]
    sj = jr.join_meshes_as_scene([mj, jr.Mesh(v + 1, f, textures=tex, texture_res=5)])
    st = jt.join_meshes_as_scene([mt, jt.Mesh(v + 1, f, textures=tex, texture_res=5,
                                              device='cpu')])
    np.testing.assert_array_equal(st.faces.numpy(), np.asarray(sj.faces))
    np.testing.assert_array_equal(st.face_vertices.numpy(), np.asarray(sj.face_vertices))
    np.testing.assert_array_equal(st.textures.numpy(), np.asarray(sj.textures))


def test_vertex_normals_segment_sum():
    """index_add_ sums every corner's contribution to its vertex."""
    v = torch.tensor([[[0., 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]])
    f = torch.tensor([[[0, 1, 2], [1, 3, 2]]])
    n = tmesh.vertex_normals_fn(v, f)
    torch.testing.assert_close(n, torch.tensor([[[0., 0, 1]] * 4]))


# --------------------------------------------------------------------------
# convert.py
# --------------------------------------------------------------------------

def test_convert_mesh_and_renderer():
    mj, _ = both_meshes(seed=5)
    arrays = convert.mesh_arrays(mj)
    mt = convert.mesh_from_numpy(arrays, device='cpu')
    for k in ('vertices', 'faces', 'textures', 'metallic_textures', 'roughness_textures'):
        np.testing.assert_array_equal(getattr(mt, k).numpy(), arrays[k])
    assert mt.faces.dtype == torch.int64
    assert (mt.texture_type, mt.texture_res) == (mj.texture_type, mj.texture_res)
    rj = jr.Renderer(backend='jax', light_intensity_ambient=0.3,
                     light_color_directionals=(1.0, 0.9, 0.8), light_directions=(0, 0.5, 1))
    rj.transform.set_eyes_from_angles(3.0, 15, 60)
    rt = jt.Renderer(device='cpu')
    convert.copy_renderer_state(rj, rt)
    assert rt.transform.eyes == rj.transform.eyes
    assert rt.lighting.ambient.light_intensity == 0.3
    assert tuple(rt.lighting.directionals[0].light_color) == (1.0, 0.9, 0.8)
    assert tuple(rt.lighting.directionals[0].light_direction) == (0, 0.5, 1)


# --------------------------------------------------------------------------
# package rules
# --------------------------------------------------------------------------

def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        'import sys\n'
        'before = set(sys.modules)\n'
        'import jrender_tpu_torch, jrender_tpu_torch.convert\n'
        'import jrender_tpu_torch.ops.softras.cuda_impl\n'
        'new = set(sys.modules) - before\n'
        'bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "jrender_tpu"))\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_file_imports_jax():
    paths = [*(REPO / 'jrender_tpu_torch').rglob('*.py'), REPO / 'chip_smoke.py',
             REPO / 'tools' / 'profile_torch_render.py']
    for path in paths:
        text = path.read_text()
        for bad in ('import jax', 'from jax', 'import jrender_tpu\n', 'from jrender_tpu ',
                    'from jrender_tpu.', 'import jrender_tpu.'):
            assert bad not in text, f'{path.name} has {bad!r}'


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    v, f, tex = sphere()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jt.Renderer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jt.Mesh(v, f)


def test_n3mr_not_ported_yet():
    with pytest.raises(NotImplementedError, match='N3MR'):
        jt.Renderer(dr_type='n3mr', device='cpu')
