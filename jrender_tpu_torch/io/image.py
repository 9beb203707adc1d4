"""Image files: read textures, write texture atlases.

Counterpart of the JAX package's ``_imread`` (``jrender_tpu/io/load_obj.py:21-28``)
and its ``imageio.imwrite`` calls (``io/save_obj.py:24``, ``scene/texture.py:95``).
Both go through the first file library that imports: ``imageio``, then
PIL, then the package's own PNG codec, written on the standard library
(``zlib``, ``struct``).  The codec is how the same files are read on a
machine that has neither library.  It reads 8-bit, non-interlaced gray,
RGB and RGBA PNGs with all five row filters and writes 8-bit RGB and RGBA
(and gray); any other file raises ``ValueError``, and no format is guessed.

``library()`` says which of the three reads and writes here.
"""
from __future__ import annotations

import importlib.util
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels (gray, RGB, RGBA)


def library() -> str:
    """'imageio', 'PIL' or 'codec': what ``imread`` and ``imwrite`` use."""
    for name in ('imageio', 'PIL'):
        if importlib.util.find_spec(name) is not None:
            return name
    return 'codec'


# -- the PNG codec ------------------------------------------------------------

def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG file (bad signature)')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f'PNG chunk {kind!r}: bad CRC')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError('PNG file ends before IEND')


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9): rows [H, stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        kind = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if kind == 0:                                   # None
            cur = row.copy()
        elif kind == 1:                                 # Sub: a running sum per channel
            cur = np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0).astype(np.uint8)
            cur = cur.reshape(-1)
        elif kind == 2:                                 # Up
            cur = row + prev
        elif kind in (3, 4):                            # Average, Paeth: left to right
            cur = bytearray(stride)
            up = prev.tolist()
            for i, v in enumerate(row.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) // 2 if kind == 3 else _paeth(a, up[i], c)
                cur[i] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f'PNG row {y}: unknown filter type {kind}')
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG as uint8 [H,W] or [H,W,C]."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG file without IHDR')
    width, height, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f'PNG of bit depth {depth}, colour type {ctype}, interlace {interlace}: '
            'the codec reads 8-bit non-interlaced gray (0), RGB (2) and RGBA (6) only')
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != height * (width * ch + 1):
        raise ValueError('PNG image data of the wrong length')
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + kind + body + struct.pack('>I', zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W] (gray), [H,W,3] (RGB) or [H,W,4] (RGBA) as PNG bytes, every
    row with filter type 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'encode_png takes uint8 images, not {img.dtype}')
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[2]) if img.ndim == 3 else None
    if ctype is None:
        raise ValueError(f'encode_png takes [H,W], [H,W,3] or [H,W,4], not {img.shape}')
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))


# -- reading and writing --------------------------------------------------------

def read_raw(path) -> np.ndarray:
    """The file's pixels as the first library that imports gives them."""
    lib = library()
    if lib == 'imageio':
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path))
    if lib == 'PIL':
        from PIL import Image
        with Image.open(path) as im:
            if im.mode == 'P':      # a palette, expanded as imageio expands it
                im = im.convert('RGBA' if 'transparency' in im.info else 'RGB')
            return np.asarray(im)
    return decode_png(Path(path).read_bytes())


def to_rgb_float(img) -> np.ndarray:
    """float32 [H,W,3] in [0,1] from an image array (uint8 counts as 0-255,
    as the JAX package's ``_imread`` divides every file by 255): gray is
    spread to 3 channels and alpha dropped."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack((img,) * 3, -1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def imread(path_or_array) -> np.ndarray:
    """float32 [H,W,3] in [0,1] (JAX ``io/load_obj.py:21-28``): a file's
    path, or its pixels as an array (uint8 or 0-255 values)."""
    if isinstance(path_or_array, (str, Path)):
        return to_rgb_float(read_raw(path_or_array))
    return to_rgb_float(path_or_array)


def imwrite(path, img) -> None:
    """Write uint8 [H,W], [H,W,3] or [H,W,4] as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'imwrite takes uint8 images, not {img.dtype}')
    lib = library()
    if lib == 'imageio':
        import imageio.v2 as imageio
        imageio.imwrite(path, img)
    elif lib == 'PIL':
        from PIL import Image
        Image.fromarray(img).save(path, format='PNG')
    else:
        Path(path).write_bytes(encode_png(img))
