"""The port's file IO against the JAX package and imageio, on the CPU.

OBJ, MTL and PNG files are written from a seed into ``tmp_path`` and
loaded by both packages: ``jrender_tpu`` and ``jrender_tpu_torch`` with
``device='cpu'``.  Vertices and faces must be exact, baked textures,
normal maps, TBN frames and texture coordinates within 1e-5 (the bilinear
fetch and the barycentric mix round alike, but the packages' einsums may
add in another order).  The port's PNG codec is held to ``imageio``
byte for byte, both ways, with every row filter.  ``save_obj`` and
``save_voxel`` must write the JAX package's text line for line.
"""
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jrender_tpu.io import load_obj as jload_obj
from jrender_tpu.io import save_obj as jsave_obj
from jrender_tpu.io import save_voxel as jsave_voxel
from jrender_tpu.io.load_obj import _imread as j_imread
from jrender_tpu.ops import texture as JT

from jrender_tpu_torch import Mesh
from jrender_tpu_torch.io import image as timage
from jrender_tpu_torch.io import load_obj, save_obj, save_voxel
from jrender_tpu_torch.io.load_obj import parse_faces, parse_vertices
from jrender_tpu_torch.native import objloader
from jrender_tpu_torch.ops import texture as TT

torch.set_num_threads(2)

TEX_ATOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the PNG codec -------------------------------------------------------------

def _image(rng, channels, h=13, w=17):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_codec_reads_what_imageio_wrote(tmp_path, channels):
    img = _image(np.random.RandomState(channels), channels)
    path = tmp_path / 'a.png'
    imageio.imwrite(path, img)
    got = timage.decode_png(path.read_bytes())
    np.testing.assert_array_equal(got, np.asarray(imageio.imread(path)))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_imageio_reads_what_the_codec_wrote(tmp_path, channels):
    img = _image(np.random.RandomState(10 + channels), channels)
    path = tmp_path / 'a.png'
    path.write_bytes(timage.encode_png(img))
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)


def _filtered_png(img, kinds):
    """PNG bytes of uint8 img [H,W,C] with row y filtered by kinds[y % 5]
    (PNG spec, section 9), written here so that every filter type occurs."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack('>I', len(body)) + kind + body + \
            struct.pack('>I', zlib.crc32(kind + body))
    return (timage.PNG_SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_codec_undoes_every_row_filter(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth in turn: the codec's
    pixels equal imageio's of the same file and the image written."""
    img = _image(np.random.RandomState(20 + channels), channels, h=11, w=9)
    img3 = img[..., None] if channels == 1 else img
    data = _filtered_png(img3, (0, 1, 2, 3, 4))
    path = tmp_path / 'f.png'
    path.write_bytes(data)
    got = timage.decode_png(data)
    np.testing.assert_array_equal(got, np.asarray(imageio.imread(path)))
    np.testing.assert_array_equal(got, img)


def test_codec_refuses_other_pngs(tmp_path):
    from PIL import Image
    pal = Image.fromarray(_image(np.random.RandomState(3), 1)).convert('P')
    pal.save(tmp_path / 'p.png')
    deep = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    deep.save(tmp_path / 'd.png')
    for name in ('p.png', 'd.png'):
        with pytest.raises(ValueError, match='codec reads 8-bit'):
            timage.decode_png((tmp_path / name).read_bytes())
    with pytest.raises(ValueError, match='not a PNG'):
        timage.decode_png(b'GIF89a' + bytes(40))


@pytest.mark.parametrize('lib', ['imageio', 'PIL', 'codec'])
def test_every_library_reads_and_writes_alike(tmp_path, monkeypatch, lib):
    """imwrite then read_raw through each library (a machine may have
    PIL and no imageio): the pixels written, as imageio reads them."""
    monkeypatch.setattr(timage, 'library', lambda: lib)
    rng = np.random.RandomState(40)
    for channels in (1, 3, 4):
        img = _image(rng, channels)
        path = tmp_path / f'{channels}.png'
        timage.imwrite(path, img)
        np.testing.assert_array_equal(timage.read_raw(path), img)
        np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    if lib != 'codec':
        from PIL import Image
        Image.fromarray(_image(rng, 3)).convert('P').save(tmp_path / 'p.png')
        np.testing.assert_array_equal(timage.read_raw(tmp_path / 'p.png'),
                                      np.asarray(imageio.imread(tmp_path / 'p.png')))


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_imread_matches_jax(tmp_path, channels):
    img = _image(np.random.RandomState(30 + channels), channels)
    path = tmp_path / 'a.png'
    imageio.imwrite(path, img)
    want = j_imread(str(path))
    np.testing.assert_array_equal(timage.imread(str(path)), want)
    np.testing.assert_array_equal(timage.imread(img), want)          # an array too
    assert timage.library() == 'imageio'


# -- the OBJ parsers -------------------------------------------------------------

def _sphere_obj(tmp_path, rng, rings=5, segs=7, mtl=None, colors=False):
    """Writes a UV sphere with vt (u, v) per vertex, quads at the middle
    rings and two materials; returns the OBJ's path."""
    vs, vts = [], []
    for r in range(rings + 1):
        for s in range(segs + 1):
            phi, th = np.pi * r / rings, 2 * np.pi * s / segs
            vs.append([np.sin(phi) * np.cos(th), np.cos(phi), np.sin(phi) * np.sin(th)])
            vts.append([s / segs, 1 - r / rings])
    vs = (np.asarray(vs) * 0.8 + rng.uniform(-0.02, 0.02, (len(vs), 3))).astype(np.float32)
    lines = [f'mtllib {mtl}'] if mtl else []
    for i, v in enumerate(vs):
        extra = ' %.6f %.6f %.6f' % tuple(rng.uniform(0, 1, 3)) if colors else ''
        lines.append('v %.8f %.8f %.8f%s' % (v[0], v[1], v[2], extra))
    for t in vts:
        lines.append('vt %.8f %.8f' % (t[0], t[1]))
    lines.append('vn 0 1 0')
    for r in range(rings):
        lines.append(f'usemtl {"red" if r % 2 else "tex"}')
        for s in range(segs):
            a, b = r * (segs + 1) + s + 1, r * (segs + 1) + s + 2
            c, d = a + segs + 1, b + segs + 1
            corner = [f'{k}/{k}' for k in (a, c, d, b)]
            lines.append('f ' + ' '.join(corner[:3] if r in (0, rings - 1) else corner))
    path = tmp_path / 'm.obj'
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def test_native_and_python_parsers_agree(tmp_path):
    path = _sphere_obj(tmp_path, np.random.RandomState(0))
    lines = open(path).readlines()
    assert objloader.available()
    parsed = objloader.parse_obj_native(path)
    np.testing.assert_array_equal(parsed.faces, parse_faces(lines))
    np.testing.assert_array_equal(parsed.vertices, parse_vertices(lines))
    assert parsed.materials == ['tex', 'red'] and parsed.faces.shape[0] > 0


def _write_mtl(tmp_path, rng, normal=None, kd_png=True, size=(12, 16)):
    lines = ['newmtl tex', 'Kd 0.2 0.4 0.6']
    if kd_png:
        imageio.imwrite(tmp_path / 'kd.png', _image(rng, 3, *size))
        lines.append('map_Kd kd.png')
    lines += ['newmtl red', 'Kd 0.9 0.1 0.1']
    if normal == 'bump':
        bump = _image(rng, 1, 10, 14)
        imageio.imwrite(tmp_path / 'nm.png', np.stack([bump] * 3, -1))
        lines.append('map_normal -bm nm.png')
    elif normal == 'rgb':
        imageio.imwrite(tmp_path / 'nm.png', _image(rng, 3, 10, 14))
        lines.append('map_normal -bm nm.png')
    (tmp_path / 'm.mtl').write_text('\n'.join(lines) + '\n')


def _both_loads(path, **kw):
    j = jload_obj(path, **kw)
    t = load_obj(path, device='cpu', **kw)
    assert len(j) == len(t)
    return j, t


@pytest.mark.parametrize('normal', [None, 'bump', 'rgb'])
@pytest.mark.parametrize('texture_res', [2, 3])
def test_load_obj_softras_matches_jax(tmp_path, normal, texture_res):
    rng = np.random.RandomState(texture_res)
    path = _sphere_obj(tmp_path, rng, mtl='m.mtl')
    _write_mtl(tmp_path, rng, normal=normal)
    j, t = _both_loads(path, load_texture=True, texture_res=texture_res)
    np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))
    assert t[1].dtype == torch.int64 and t[0].device.type == 'cpu'
    for got, want in zip(t[2:], j[2:]):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=TEX_ATOL, rtol=0)
    if normal is not None:
        assert t[3].shape == (t[1].shape[0], texture_res ** 2, 3)


@pytest.mark.parametrize('use_bilinear', [True, False])
@pytest.mark.parametrize('wrap', list(JT.WRAPPING))
def test_load_obj_n3mr_matches_jax(tmp_path, wrap, use_bilinear):
    """The test_texture_wrap.py set in parity form: texture coordinates
    outside [0, 1] under every wrap mode, bilinear and nearest."""
    rng = np.random.RandomState(7)
    path = _sphere_obj(tmp_path, rng, mtl='m.mtl')
    text = open(path).read().replace('vt ', 'vt_ ')
    out = []
    for ln in text.splitlines():
        if ln.startswith('vt_ '):
            u, v = (float(x) for x in ln.split()[1:])
            ln = 'vt %.8f %.8f' % (u * 2.6 - 0.8, v * 2.2 - 0.6)
        out.append(ln)
    open(path, 'w').write('\n'.join(out) + '\n')
    _write_mtl(tmp_path, rng)
    j, t = _both_loads(path, load_texture=True, texture_res=3, dr_type='n3mr',
                       texture_wrapping=wrap, use_bilinear=use_bilinear)
    np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))
    np.testing.assert_allclose(_np(t[2]), np.asarray(j[2]), atol=TEX_ATOL, rtol=0)


def test_load_obj_vertex_colors_and_normalization(tmp_path):
    path = _sphere_obj(tmp_path, np.random.RandomState(5), colors=True)
    j, t = _both_loads(path, load_texture=True, texture_type='vertex', normalization=True)
    np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))
    j, t = _both_loads(path, normalization=True)
    np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))


# -- texture ops ------------------------------------------------------------------

def test_create_texture_image_matches_jax():
    tex = np.random.RandomState(1).rand(11, 9, 3).astype(np.float32)
    ji, jv = JT.create_texture_image(jnp.asarray(tex), 8)
    ti, tv = TT.create_texture_image(torch.as_tensor(tex), 8)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, np.asarray(ji))


def test_bump_to_normal_and_tbn_match_jax():
    rng = np.random.RandomState(2)
    bump = rng.rand(9, 12).astype(np.float32)
    np.testing.assert_allclose(_np(TT.bump_to_normal(torch.as_tensor(bump))),
                               JT.bump_to_normal(bump), atol=1e-6, rtol=0)
    fc = rng.rand(20, 3, 2).astype(np.float32)
    fw = rng.randn(20, 3, 3).astype(np.float32)
    np.testing.assert_allclose(_np(TT.create_TBN(torch.as_tensor(fc), torch.as_tensor(fw))),
                               np.asarray(JT.create_TBN(jnp.asarray(fc), jnp.asarray(fw))),
                               atol=TEX_ATOL, rtol=0)


# -- saving -------------------------------------------------------------------

def test_save_obj_text_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    v = rng.randn(9, 3).astype(np.float32)
    f = rng.randint(0, 9, (6, 3)).astype(np.int32)
    tex = rng.rand(6, 4, 3).astype(np.float32)
    vcol = rng.rand(9, 3).astype(np.float32)
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    for name, kw in (('plain', {}), ('surf', dict(textures=tex, texture_res=8)),
                     ('vert', dict(textures=vcol, texture_type='vertex'))):
        jsave_obj(str(tmp_path / 'j' / f'{name}.obj'), v, f, **kw)
        save_obj(str(tmp_path / 't' / f'{name}.obj'), torch.as_tensor(v),
                 torch.as_tensor(f), **{k: torch.as_tensor(x) if isinstance(x, np.ndarray)
                                        else x for k, x in kw.items()})
    for p in sorted((tmp_path / 'j').iterdir()):
        q = tmp_path / 't' / p.name
        if p.suffix == '.png':
            np.testing.assert_array_equal(imageio.imread(q), imageio.imread(p))
        else:
            assert q.read_text().splitlines() == p.read_text().splitlines(), p.name
    vox = (rng.rand(5, 5, 5) > 0.6).astype(np.int32)
    jsave_voxel(str(tmp_path / 'j' / 'vox.obj'), vox)
    save_voxel(str(tmp_path / 't' / 'vox.obj'), torch.as_tensor(vox))
    assert (tmp_path / 't' / 'vox.obj').read_text() == (tmp_path / 'j' / 'vox.obj').read_text()


def test_mesh_from_obj_save_obj_round_trip(tmp_path):
    rng = np.random.RandomState(6)
    path = _sphere_obj(tmp_path, rng, mtl='m.mtl')
    _write_mtl(tmp_path, rng, normal='rgb')
    mesh = Mesh.from_obj(path, load_texture=True, texture_res=3, device='cpu')
    assert mesh.normal_textures is not None and mesh.TBN.shape[-2:] == (3, 3)
    assert mesh.face_texcoords.shape == (1, mesh.num_faces, 3, 2)
    assert mesh.surface_ResNormals.shape == (1, mesh.num_faces, 9, 3)
    out = str(tmp_path / 'out.obj')
    mesh.save_obj(out, save_texture=True, texture_res_out=16)
    again = Mesh.from_obj(out, load_texture=True, texture_res=3, device='cpu')
    np.testing.assert_allclose(_np(again.vertices), _np(mesh.vertices), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(_np(again.faces), _np(mesh.faces))
    # the atlas holds texels cut to 8 bits (x * 255 truncated); a texel baked
    # back reads its own atlas cell
    np.testing.assert_allclose(_np(again.textures), _np(mesh.textures), atol=1 / 255 + 1e-6,
                               rtol=0)
    plain = str(tmp_path / 'plain.obj')
    mesh.save_obj(plain)
    again = Mesh.from_obj(plain, device='cpu')
    np.testing.assert_array_equal(_np(again.faces), _np(mesh.faces))


@pytest.mark.parametrize('normal', [None, 'bump'])
def test_lighting_of_a_loaded_mesh_matches_jax(tmp_path, normal):
    """Demo 1's lighting of a mesh from its files: per texel through the
    normal map (``surface_ResNormals``) where the MTL names one, per face
    otherwise; ambient, a directional light and Cook-Torrance specular."""
    from jrender_tpu import Mesh as JMesh
    from jrender_tpu.lighting import Lighting as JLighting
    from jrender_tpu_torch.lighting import Lighting
    rng = np.random.RandomState(11)
    path = _sphere_obj(tmp_path, rng, mtl='m.mtl')
    _write_mtl(tmp_path, rng, normal=normal)
    jm = JMesh.from_obj(path, load_texture=True, texture_res=3)
    tm = Mesh.from_obj(path, load_texture=True, texture_res=3, device='cpu')
    kw = dict(intensity_ambient=0.3, intensity_directionals=0.7, directions=[0.3, 0.5, -1])
    want = np.asarray(JLighting(**kw)(jm, eyes=[0.2, 0.4, -2.5]).textures)
    got = _np(Lighting(**kw)(tm, eyes=[0.2, 0.4, -2.5]).textures)
    assert (normal is None) == (tm.normal_textures is None)
    np.testing.assert_allclose(got, want, atol=TEX_ATOL, rtol=0)


def test_load_obj_without_a_device_raises_without_a_card(tmp_path, monkeypatch):
    path = _sphere_obj(tmp_path, np.random.RandomState(8))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_obj(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.from_obj(path)
