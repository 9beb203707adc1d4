"""The port's scene pipeline and screen-space ops against the JAX package, on the CPU.

The same numpy inputs, and the same OBJ/MTL files written into
``tmp_path``, go to ``jrender_tpu`` and to ``jrender_tpu_torch`` with
``device='cpu'``.  Random draws are the JAX package's own: SSAO and SSDO
take ``jax.random.uniform(PRNGKey(0), (n, 3))``, SSSR the draws of its
``fold_in(PRNGKey(0), k)`` keys, passed to the port as ``samples``.

Tolerances: elementwise image ops within 1e-5; buffers and rendered
images within 1e-4, except at most 1% of the pixels (a knife edge of the
rasterizer, or a march whose hit flips on a depth compare); face ids
exact, except at most 1% of the pixels.  The summed-area table adds in
the JAX package's order and is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrender_tpu.ops import image as JI
from jrender_tpu.ops.voxelize import voxelization as jvoxelization
from jrender_tpu import scene as JS
from jrender_tpu.structures import Mesh as JMesh

from jrender_tpu_torch import convert
from jrender_tpu_torch import scene as TS
from jrender_tpu_torch.ops import image as TI
from jrender_tpu_torch.ops.voxelize import voxelization
from jrender_tpu_torch.structures import Mesh

torch.set_num_threads(2)

OP_ATOL = 1e-5
IMG_ATOL = 1e-4
FRAC = 0.01


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def assert_image_close(got, want, atol=IMG_ATOL, frac=FRAC):
    """All but ``frac`` of the pixels (channels on the last axis) within atol."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    bad = d.reshape(d.shape[0], d.shape[1], -1).max(-1) > atol
    assert bad.mean() <= frac, f'{bad.mean():.4f} of pixels beyond {atol} (max {d.max():.3g})'
    return bad.mean()


# -- image ops ------------------------------------------------------------------

def test_sample_conv_stretch_sat_match_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(12, 10, 3).astype(np.float32)
    pos = rng.uniform(-0.1, 1.1, (7, 5, 2)).astype(np.float32)
    for tex in (img, img[..., 0]):
        np.testing.assert_allclose(_np(TI.sample2D(_t(tex), _t(pos))),
                                   np.asarray(JI.sample2D(jnp.asarray(tex), jnp.asarray(pos))),
                                   atol=OP_ATOL, rtol=0)
    w = rng.rand(5, 3).astype(np.float32)
    for x, over in ((img, 0.0), (img[..., 1], 1.0)):
        np.testing.assert_allclose(_np(TI.conv_for_image(_t(x), _t(w), over)),
                                   np.asarray(JI.conv_for_image(jnp.asarray(x), jnp.asarray(w),
                                                                over)),
                                   atol=OP_ATOL, rtol=0)
    for got, want in zip(TI.compute_stretch_map(_t(img)), JI.compute_stretch_map(jnp.asarray(img))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=OP_ATOL)
    big = rng.uniform(0, 100, (40, 37)).astype(np.float32)
    np.testing.assert_array_equal(_np(TI.generate_SAT(_t(big))),
                                  np.asarray(JI.generate_SAT(jnp.asarray(big))))


@pytest.mark.parametrize('dim', [0, 1])
def test_gaussian_blur_matches_jax(dim):
    rng = np.random.RandomState(dim)
    img = np.where(rng.rand(24, 20) < 0.2, 0.0, rng.rand(24, 20)).astype(np.float32)
    mod = rng.uniform(0.2, 1.0, (24, 20)).astype(np.float32)
    np.testing.assert_allclose(_np(TI.gaussian_blur(_t(img), 7, 25, _t(mod), dim)),
                               np.asarray(JI.gaussian_blur(jnp.asarray(img), 7, 25,
                                                           jnp.asarray(mod), dim)),
                               atol=OP_ATOL, rtol=0)


def test_fxaa_and_bilateral_match_jax():
    rng = np.random.RandomState(3)
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 13:] = 1.0
    img[9:20, 4:11] = rng.rand(11, 7, 3)
    np.testing.assert_allclose(_np(TI.FXAA(_t(img))), np.asarray(JI.FXAA(jnp.asarray(img))),
                               atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(_np(TI.bilateral_filter(_t(img))),
                               np.asarray(JI.bilateral_filter(jnp.asarray(img))),
                               atol=OP_ATOL, rtol=0)


def _step_scene(is_=32):
    depth = np.full((is_, is_), 5.0, np.float32)
    depth[:, is_ // 2:] = 2.0
    depth[4:9, 3:7] = 3.0
    normals = np.zeros((is_, is_, 3), np.float32)
    normals[..., 2] = -1.0
    normals[4:9, 3:7] = [0.6, 0.0, -0.8]
    fi = np.zeros((is_, is_), np.int32)
    fi[:3, :5] = -1
    color = np.zeros((is_, is_, 3), np.float32)
    color[:, is_ // 2:] = [0.9, 0.1, 0.1]
    color[:, :is_ // 2] = [0.2, 0.3, 0.4]
    return depth, normals, fi, color


def test_ssao_ssdo_match_jax_on_its_draws():
    depth, normals, fi, color = _step_scene()
    n_ao, n_do = 64, 48
    key = jax.random.PRNGKey(0)
    want = JI.SSAO(jnp.asarray(depth), jnp.asarray(fi), jnp.asarray(normals), 0.5,
                   sample_num=n_ao, sample_range_r=2.0)
    got = TI.SSAO(_t(depth), _t(fi), _t(normals), 0.5, sample_num=n_ao, sample_range_r=2.0,
                  samples=np.asarray(jax.random.uniform(key, (n_ao, 3))))
    assert np.asarray(want).max() > 0
    assert_image_close(got[..., None], np.asarray(want)[..., None], atol=OP_ATOL)
    want = JI.SSDO(jnp.asarray(color), jnp.asarray(depth), jnp.asarray(fi),
                   jnp.asarray(normals), 0.5, sample_num=n_do, sample_range_r=2.0)
    got = TI.SSDO(_t(color), _t(depth), _t(fi), _t(normals), 0.5, sample_num=n_do,
                  sample_range_r=2.0, samples=np.asarray(jax.random.uniform(key, (n_do, 3))))
    assert_image_close(got, want, atol=OP_ATOL)
    # the port's own draws: a generator seeded 0 by default, reproducible
    a = TI.SSAO(_t(depth), _t(fi), _t(normals), 0.5, sample_num=n_ao, sample_range_r=2.0)
    b = TI.SSAO(_t(depth), _t(fi), _t(normals), 0.5, sample_num=n_ao, sample_range_r=2.0,
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.max() > 0


def _mirror_floor_scene(is_=64, width=0.5):
    """A mirror floor at y = -1 (bottom half) and a red wall at z = 5, as in
    tests/test_scene_render2.py."""
    ys, xs = np.meshgrid(np.arange(is_), np.arange(is_), indexing='ij')
    xi = (2 * xs + 1 - is_) / is_
    yi = (2 * (is_ - 1 - ys) + 1 - is_) / is_
    floor_z = np.where(yi < -0.05, -1.0 / (yi * width), 100.0)
    depth = np.minimum(floor_z, 5.0).astype(np.float32)
    is_floor = floor_z < 5.0
    world = np.stack([xi * width * depth, yi * width * depth, depth], -1).astype(np.float32)
    normals = np.where(is_floor[..., None], np.float32([0, 1, 0]),
                       np.float32([0, 0, -1])).astype(np.float32)
    color = np.where(is_floor[..., None], np.float32([0.1, 0.1, 0.1]),
                     np.float32([0.9, 0.1, 0.1])).astype(np.float32)
    faces_ind = np.where(is_floor, 0, 1000).astype(np.int32)
    return world, normals, color, faces_ind, np.array([0, 500], np.int32), is_floor


@pytest.mark.parametrize('mode', ['naive', 'hiz'])
def test_ssr_matches_jax_on_a_mirror_floor(mode):
    width = 0.5
    world, normals, color, fi, ssr_faces, is_floor = _mirror_floor_scene(width=width)
    jfn, tfn = (JI.SSR, TI.SSR) if mode == 'naive' else (JI.SSR_hiz, TI.SSR_hiz)
    kw = dict(world_thickness=0.5) if mode == 'hiz' else {}
    want = np.asarray(jfn(jnp.asarray(color), jnp.asarray(world), jnp.asarray(normals),
                          jnp.asarray(fi), ssr_faces, width, 100.0, **kw))
    got = tfn(_t(color), _t(world), _t(normals), _t(fi), ssr_faces, width, 100.0, **kw)
    assert (want - color)[is_floor].max() > 0.2
    assert_image_close(got, want, atol=OP_ATOL)


def test_sssr_matches_jax_on_its_draws():
    is_, width, spp = 32, 0.5, 4
    world, normals, color, fi, ssr_faces, _ = _mirror_floor_scene(is_=is_, width=width)
    rough = np.full((is_, is_, 1), 0.3, np.float32)
    key = jax.random.PRNGKey(0)
    draws = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, k), (2, is_, is_)))
                      for k in range(spp)])
    want = np.asarray(JI.SSSR(jnp.asarray(color), jnp.asarray(world), jnp.asarray(normals),
                              jnp.asarray(rough), jnp.asarray(fi), ssr_faces, width, 100.0,
                              spp=spp))
    got = TI.SSSR(_t(color), _t(world), _t(normals), _t(rough), _t(fi), ssr_faces, width,
                  100.0, spp=spp, samples=draws)
    assert np.abs(want).max() > 0.05
    assert_image_close(got, want, atol=OP_ATOL)


# -- voxels ------------------------------------------------------------------------

def test_voxelization_is_exact():
    lo, hi = 0.25, 0.75
    corners = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)],
                       np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [t for a, b, c, d in quads for t in ([a, b, c], [a, c, d])]
    fv = corners[np.asarray(tris)][None]
    for size in (8, 16):
        np.testing.assert_array_equal(_np(voxelization(_t(fv), size, device='cpu')),
                                      np.asarray(jvoxelization(jnp.asarray(fv), size)))
    rng = np.random.RandomState(1)
    verts = rng.uniform(-0.45, 0.45, (30, 3)).astype(np.float32)
    faces = rng.randint(0, 30, (60, 3))
    jm = JMesh(verts, faces.astype(np.int32))
    tm = Mesh(verts, faces, device='cpu')
    np.testing.assert_array_equal(_np(tm.voxelize(16)), np.asarray(jm.voxelize(16)))


# -- the scene ------------------------------------------------------------------------

SCENE_OBJ = """mtllib scene.mtl
v -2 -0.5 -2
v 2 -0.5 -2
v 2 -0.5 2
v -2 -0.5 2
v -0.4 -0.5 -0.4
v 0.4 -0.5 -0.4
v 0.4 0.4 -0.4
v -0.4 0.4 -0.4
v 0.5 -0.5 0.6
v 1.2 -0.5 0.6
v 0.85 0.3 0.4
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl floor
f 1/1 3/3 2/2
f 1/1 4/4 3/3
usemtl cube
f 5/1 7/3 6/2
f 5/1 8/4 7/3
usemtl tri
f 9/1 11/3 10/2
"""


def write_scene(tmp_path, textured=True):
    """A floor (the mirror), a box face and a triangle, lit from above: the
    floor takes a map_Kd texture from a PNG."""
    (tmp_path / 'scene.obj').write_text(SCENE_OBJ)
    mtl = ['newmtl floor', 'Kd 0.7 0.7 0.7', 'newmtl cube', 'Kd 0.8 0.2 0.2',
           'newmtl tri', 'Kd 0.2 0.6 0.9']
    if textured:
        import imageio.v2 as imageio
        imageio.imwrite(tmp_path / 'floor.png',
                        np.random.RandomState(0).randint(0, 256, (8, 8, 3)).astype(np.uint8))
        mtl.insert(2, 'map_Kd floor.png')
    (tmp_path / 'scene.mtl').write_text('\n'.join(mtl) + '\n')
    return str(tmp_path / 'scene.obj')


LIGHTS = {
    'directional': dict(position=[0, 3, -3], direction=[0, -0.7, 0.7], type='directional',
                        intensity=0.8, viewing_scale=0.4),
    'point': dict(position=[0.3, 2.5, -2.0], direction=[0, -0.8, 0.6], type='point',
                  intensity=0.9),
    'area': dict(position=[-0.5, 2.5, -2.5], direction=[0.2, -0.7, 0.7], type='area',
                 intensity=0.9),
}


def _sssr_draws(is_, spp=32):
    key = jax.random.PRNGKey(0)
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, k), (2, is_, is_)))
                     for k in range(spp)])


def render_both(path, shading, lights, reflections, is_=32, ssr_mode='naive'):
    """(JAX scene, port scene, JAX image, port image) of the scene file."""
    scenes = []
    for pkg, kw in ((JS, {}), (TS, {'device': 'cpu'})):
        s = pkg.Scene.load_scene_from_obj(path, **kw)
        for light in lights:
            s.append_light(pkg.Light(**light))
        for i, kind in reflections:
            s.set_reflection(i, kind)
        s.set_render(pkg.Render(image_size=is_, camera_mode='look', eye=[0, 1.0, -3.0],
                                camera_direction=[0, -0.25, 1.0], ssr_mode=ssr_mode, **kw))
        scenes.append(s)
    scenes[1].render.sssr_samples = _sssr_draws(is_)
    return (*scenes, np.asarray(scenes[0].deferred_render(shading=shading)),
            scenes[1].deferred_render(shading=shading))


def assert_buffers_close(js, ts):
    jr, tr = js.render, ts.render
    ids_j, ids_t = np.asarray(jr.faces_ind_buffer), _np(tr.faces_ind_buffer)
    assert (ids_j >= 0).any() and (ids_j < 0).any()
    assert (ids_j != ids_t).mean() <= FRAC
    assert_image_close(tr.world_buffer, jr.world_buffer)
    assert_image_close(tr.normal_buffer, jr.normal_buffer)
    assert_image_close(tr.KD_buffer, jr.KD_buffer)
    for jl, tl in zip(jr.lights, tr.lights):
        if jl.DepthMap is not None:
            assert_image_close(tl.DepthMap.image[..., None], np.asarray(jl.DepthMap.image)[..., None])


@pytest.mark.parametrize('shadow', [False, True])
@pytest.mark.parametrize('light', list(LIGHTS))
@pytest.mark.parametrize('shading', ['blinn_phong', 'Cook_Torrance'])
def test_deferred_render_matches_jax(tmp_path, shading, light, shadow):
    """Each light type with and without its shadow (PCF for the point and
    directional lights, VSSM for the area light), the floor a mirror; under
    Cook-Torrance the triangle is glossy (SSSR reads the metallic-roughness
    buffer, which only Cook-Torrance fills)."""
    path = write_scene(tmp_path)
    lights = [dict(LIGHTS[light], shadow=shadow), dict(type='ambient', intensity=0.3,
                                                      shadow=False)]
    refl = [(0, 'mirror')] + ([(2, 'glossy')] if shading == 'Cook_Torrance' else [])
    js, ts, want, got = render_both(path, shading, lights, refl)
    assert want.max() > 0.2
    assert_image_close(got, want)
    assert_buffers_close(js, ts)
    if shading == 'Cook_Torrance':
        assert_image_close(ts.render.metallic_roughness_buffer,
                           js.render.metallic_roughness_buffer)


def test_hiz_deferred_render_and_occlusion_match_jax(tmp_path):
    """The Hi-Z march in the pipeline, then SSAO and SSDO on the JAX draws."""
    path = write_scene(tmp_path)
    lights = [dict(LIGHTS['point'], shadow=True), dict(type='ambient', intensity=0.3,
                                                      shadow=False)]
    js, ts, want, got = render_both(path, 'blinn_phong', lights, [(0, 'mirror')],
                                    ssr_mode='hiz')
    assert_image_close(got, want)
    key = jax.random.PRNGKey(0)
    assert_image_close(ts.render.SSAO(_t(want), sample_num=64,
                                      samples=np.asarray(jax.random.uniform(key, (64, 3)))),
                       js.render.SSAO(jnp.asarray(want), sample_num=64))
    assert_image_close(ts.render.SSDO(_t(want), sample_num=64,
                                      samples=np.asarray(jax.random.uniform(key, (64, 3)))),
                       js.render.SSDO(jnp.asarray(want), sample_num=64))


def test_scene_loader_and_mrt_match_jax(tmp_path):
    path = write_scene(tmp_path)
    js = JS.Scene.load_scene_from_obj(path)
    ts = TS.Scene.load_scene_from_obj(path, device='cpu')
    assert list(ts.name_dic) == list(js.name_dic) == ['floor', 'cube', 'tri']
    for jo, to in zip(js.objects, ts.objects):
        np.testing.assert_array_equal(_np(to.face_vertices), np.asarray(jo.face_vertices))
        np.testing.assert_array_equal(_np(to._kd_texture_uv), np.asarray(jo._kd_texture_uv))
        assert to.map_Kd_path == jo.map_Kd_path
    ts.set_render_target([0, 2])
    js.set_render_target([0, 2])
    for name in ('worldcoords', 'normals', 'KD', 'albedo', 'metallic_roughness'):
        np.testing.assert_allclose(_np(getattr(ts.MRT, name)), np.asarray(getattr(js.MRT, name)),
                                   atol=OP_ATOL, rtol=0)
    assert ts.GeometryDesc().obj_faces == js.GeometryDesc().obj_faces
    # kd textures baked per face (kd_res) through load_textures_softras
    ts.set_kd_res(4)
    js.set_kd_res(4)
    np.testing.assert_allclose(_np(ts.MRT.KD), np.asarray(js.MRT.KD), atol=OP_ATOL, rtol=0)


def test_scene_from_numpy_renders_as_jax(tmp_path):
    path = write_scene(tmp_path, textured=False)
    js = JS.Scene.load_scene_from_obj(path)
    js.append_light(JS.Light(**dict(LIGHTS['directional'], shadow=True)))
    js.set_reflection(0, 'mirror')
    js.set_roughness(2, 0.4)
    js.set_render(JS.Render(image_size=32, camera_mode='look', eye=[0, 1.0, -3.0],
                            camera_direction=[0, -0.25, 1.0]))
    ts = convert.scene_from_numpy(convert.scene_arrays(js), device='cpu',
                                  render=TS.Render(image_size=32, camera_mode='look',
                                                   eye=[0, 1.0, -3.0],
                                                   camera_direction=[0, -0.25, 1.0],
                                                   device='cpu'))
    assert_image_close(ts.deferred_render('Cook_Torrance'), js.deferred_render('Cook_Torrance'))


def test_texture_mipmap_and_sampling_match_jax(tmp_path):
    """``generate_mipmap``: PIL's BILINEAR (the JAX package) against
    ``interpolate(antialias=True)`` (the port), read at 2e-6 here."""
    rng = np.random.RandomState(9)
    img = rng.rand(20, 13).astype(np.float32)
    jm, ji = JS.Texture.generate_mipmap(img)
    tm, ti = TS.Texture.generate_mipmap(_t(img))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=2e-6, rtol=0)
    import imageio.v2 as imageio
    imageio.imwrite(tmp_path / 't.png', rng.randint(0, 256, (6, 7, 4)).astype(np.uint8))
    jt = JS.Texture.from_path(str(tmp_path / 't.png'))
    tt = TS.Texture.from_path(str(tmp_path / 't.png'), device='cpu')
    uv = rng.uniform(0, 1, (5, 3, 2)).astype(np.float32)
    jt.uv, tt.uv = jnp.asarray(uv), _t(uv)
    np.testing.assert_allclose(_np(tt.query_uv), np.asarray(jt.query_uv), atol=OP_ATOL, rtol=0)
    assert tt.channel == jt.channel == 3
