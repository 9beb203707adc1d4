"""The port's texture-space subsurface scattering (SSS) against the JAX package, on the CPU.

SSS rasterizes the UV layout at a fixed 2048 x 2048 (three maps: world
coordinates, irradiance, specular), blurs the irradiance with
stretch-modulated Gaussians and resamples the result into the mesh's
texels.  Both packages run it through ``Lighting`` on the same mesh of 8
faces (``with_SSS``): the textures it writes and the frame rendered from
them are held within 1e-4 (the JAX suite's image tolerance), all but 1% of
the texels and pixels.  The blur and the stretch maps are held at 2048 x
2048 within 1e-5 of the JAX functions.
"""
import jax.numpy as jnp
import numpy as np
import torch

from jrender_tpu import Mesh as JMesh
from jrender_tpu import Renderer as JRenderer
from jrender_tpu.ops import image as JI

from jrender_tpu_torch import Mesh, Renderer
from jrender_tpu_torch.ops import image as TI

torch.set_num_threads(4)

OP_ATOL = 1e-5
IMG_ATOL = 1e-4
FRAC = 0.01


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _share_beyond(got, want, atol):
    d = np.abs(_np(got).astype(np.float64) - _np(want).astype(np.float64))
    return (d.reshape(-1, d.shape[-1]).max(-1) > atol).mean(), d.max()


def _patch():
    """A 2 x 2 grid of quads (8 faces) facing the camera, each face's UV
    triangle in a cell of a 4 x 2 atlas."""
    xs = np.linspace(-0.6, 0.6, 3)
    verts = np.array([[x, y, 0.05 * x * y] for y in xs for x in xs], np.float32)
    faces, uvs = [], []
    for j in range(2):
        for i in range(2):
            a, b, c, d = j * 3 + i, j * 3 + i + 1, (j + 1) * 3 + i, (j + 1) * 3 + i + 1
            faces += [[a, c, b], [b, c, d]]
    for k in range(8):
        u0, v0 = 0.05 + 0.24 * (k % 4), 0.08 + 0.48 * (k // 4)
        uvs.append([[u0, v0], [u0 + 0.2, v0], [u0 + 0.05, v0 + 0.4]])
    return verts, np.asarray(faces, np.int32), np.asarray(uvs, np.float32)


def test_sss_through_lighting_matches_jax():
    verts, faces, uvs = _patch()
    R = 3
    tex = np.random.RandomState(0).uniform(0.3, 0.9, (1, 8, R * R, 3)).astype(np.float32)
    kw = dict(image_size=64, light_intensity_ambient=0.4, light_intensity_directionals=0.6,
              light_directions=[0, 0.3, -1])
    jm = JMesh(verts, faces, textures=tex, texture_res=R, with_SSS=True, face_texcoords=uvs)
    want = JRenderer(**kw).render_mesh(jm)
    tm = Mesh(verts, faces, textures=tex, texture_res=R, with_SSS=True, face_texcoords=uvs,
              device='cpu')
    got = Renderer(device='cpu', **kw).render_mesh(tm)

    jt, tt = np.asarray(jm.textures), _np(tm.textures)
    assert tt.shape == (1, 8, R * R, 3) and np.isfinite(tt).all()
    assert np.abs(jt - tex).max() > 0.05           # SSS changed the textures
    share, err = _share_beyond(tt[0], jt[0], IMG_ATOL)
    assert share <= FRAC, f'textures: {share:.4f} of texels beyond {IMG_ATOL} (max {err:.3g})'
    rgb_j, rgb_t = np.asarray(want)[0].transpose(1, 2, 0), _np(got)[0].transpose(1, 2, 0)
    share, err = _share_beyond(rgb_t, rgb_j, IMG_ATOL)
    assert share <= FRAC, f'frame: {share:.4f} of pixels beyond {IMG_ATOL} (max {err:.3g})'
    assert rgb_j.max() > 0.1


def test_sss_blur_and_stretch_maps_at_2048():
    rng = np.random.RandomState(1)
    n = 2048
    world = np.zeros((n, n, 3), np.float32)
    world[200:1800, 300:1700] = rng.uniform(0, 255, (1600, 1400, 3)).astype(np.float32) * 0.02 \
        + np.linspace(0, 200, 1400, dtype=np.float32)[None, :, None]
    su_j, sv_j = JI.compute_stretch_map(jnp.asarray(world * 7))
    su_t, sv_t = TI.compute_stretch_map(torch.from_numpy(world * 7))
    for got, want in ((su_t, su_j), (sv_t, sv_j)):
        want = np.asarray(want)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(_np(got)), fin)
        np.testing.assert_allclose(_np(got)[fin], want[fin], rtol=1e-5, atol=OP_ATOL)
    mod = np.clip(np.nan_to_num(np.asarray(su_j), posinf=1.0), 0, 1).astype(np.float32)
    img = np.where(world[..., 0] > 0, rng.rand(n, n), 0).astype(np.float32)
    for dim in (0, 1):
        np.testing.assert_allclose(
            _np(TI.gaussian_blur(torch.from_numpy(img), 7, 75, torch.from_numpy(mod), dim)),
            np.asarray(JI.gaussian_blur(jnp.asarray(img), 7, 75, jnp.asarray(mod), dim)),
            atol=OP_ATOL, rtol=0)
