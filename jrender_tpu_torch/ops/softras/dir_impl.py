"""SoftRas without binning, for small meshes: the ``dir`` route.

Counterpart of ``jrender_tpu/ops/softras/dir_impl.py`` (``dir_max_faces``
:64, ``_dir_tile`` :74, ``prep_dir`` :99, ``soft_rasterize_fwd_dir`` :405,
``soft_rasterize_bwd_dir`` :684).  SoftRas has three routes, which
``route.py`` chooses as the JAX package's ``_pallas_route`` (api.py:49-75)
chooses its layouts: this one, ``dir``; ``pxg`` (``pxg_impl``, under
``JR_LAYOUT=pxg``); and the binned one (``cuda_impl``).  Under the default
layout a mesh of at most ``JR_DIR_MAX`` faces (default 0: the route is off,
as in the JAX package) on an image size divisible by 16 or 8 skips the
binning: each
screen tile walks the whole face table, culled face by face with the
faces' bboxes, in Morton order of their bbox centres; the forward finds
the top-K threshold in the same walk; the backward sums each face's
gradient over the pixels of its bbox.  The variable is read at call time.

``JR_DIR_TILE`` and ``JR_DIR_SORT`` are knobs of the TPU layout (the tile
of its grid step, and turning the Morton order off) and have no
counterpart: the CUDA kernels use 16 x 16 pixel blocks at any size, and
the faces are always in Morton order.  The order matters for speed only;
the original ids ride along, so results do not depend on it.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_dir_prep`` csrc/softras_dir_prep.cu the bboxes in Morton order,
                                               the unions of every 256
                                               places and the backward's
                                               work items
  ``launch_dir_fwd``  csrc/softras_dir_fwd.cu  image, aggregates, candidate
                                               counts and, when asked, the
                                               top-K threshold
  ``launch_dir_bwd``  csrc/softras_dir_bwd.cu  face and texture gradients,
                                               in the faces' original order

The backward's work items are the (face, split) pairs that hold pixels:
the prep of a step that will take a gradient lists them on the device and
copies their count to the host without waiting for it (pinned memory and
an event), and the backward waits on that event alone (``item_count``),
which is long done by then.  ``prep_plain`` is the prep kernel's plain
version (``window_boxes``, ``bwd_items``); ``bwd_items_plain`` and
``bwd_split_plain`` are the plain versions of the items and of the
backward summed item by item; ``warp_cull_plain`` is the plain version of
the forward's warp cull.  The forward stages the listed faces' rows in one
of two ways, chosen from the mesh's density (``fwd_warp_rows``); both give
the same bits.

``forward`` and ``backward`` go by the device of their input: a CPU tensor
takes the plain version (``fwd_plain``, ``bwd_plain``, built on
``torch_impl``), a CUDA tensor the kernel.  There is no fallback: a CUDA
input launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import os
import time
from typing import NamedTuple

import torch

from ... import _build
from . import cuda_impl, torch_impl
from .cuda_impl import ROW_BASE, SMEM_BYTES, _Scalars, _check, _entry, _run, _scalars
from .geometry import border_inflation
from .params import SoftRasParams

MAX_SPLITS = 64        # most backward warps that share one face
SPLIT_PIXELS = 1 << 14  # image pixels per backward warp of a screen-filling face


def dir_max_faces() -> int:
    """Largest face count routed to ``dir``: ``JR_DIR_MAX``, default 0 (off)."""
    return int(os.environ.get('JR_DIR_MAX', '0'))


@contextlib.contextmanager
def with_dir_max(max_faces: int):
    """``JR_DIR_MAX`` set to ``max_faces`` inside the block (0: the route
    is off), restored after it."""
    saved = os.environ.get('JR_DIR_MAX')
    os.environ['JR_DIR_MAX'] = str(max_faces)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop('JR_DIR_MAX', None)
        else:
            os.environ['JR_DIR_MAX'] = saved


def dir_tile(image_size: int) -> int:
    """The JAX layout's tile for this size, 16 or 8, or 0 where neither
    divides it (then the route is not taken)."""
    for t in (16, 8):
        if image_size % t == 0:
            return t
    return 0


class DirItems(NamedTuple):
    """The backward's work items: one for each (face, split) with split <
    min(splits, the face's chunks of 32 pixels), face after face in Morton
    place order (batch-major).  An item's number is its unit's offset plus
    its face's offset within the unit (units of 256 places, as the prep
    kernel scans them)."""
    uoff: torch.Tensor          # [B * U + 1] i32 each unit's first item; uoff[-1] is the count
    loff: torch.Tensor          # [B * F] i32 each face's first item within its unit
    done: torch.Tensor          # [B * F] i32 zero: the backward's face counters
    count: torch.Tensor         # [1] i32 the count on the host (pinned, filled after `ready`)
    ready: object               # torch.cuda.Event after the count's copy, or None on the CPU
    splits: int                 # items a face's chunks are dealt over, at most
    image_size: int


class DirInputs(NamedTuple):
    """What the dir kernels read: the face table in Morton order."""
    rows: torch.Tensor      # [B, F, 31 + 3T] f32 face rows (cuda_impl.face_rows), Morton order
    bbox: torch.Tensor      # [B, F, 4] f32 xmin, xmax, ymin, ymax, inflated by sqrt(threshold)
    ids: torch.Tensor       # [B, F] i32 original id of the face at each place
    inv: torch.Tensor       # [B, F] i32 place of each original face
    tex_res: int            # R, T = R * R (1 for vertex colours)
    wbox: torch.Tensor      # [B, ceil(F / 256), 4] each 256 places' bbox union
    items: DirItems | None  # the backward's work items (prep_dir(..., for_grad=True)), or None


def morton16(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Interleave two 4-bit coordinates into an 8-bit Morton code (x in the
    even bits), the JAX package's ``_morton16`` in a few whole-tensor ops."""
    def spread(v):                      # 0000abcd -> 0a0b0c0d
        v = (v | (v << 2)) & 0x33
        return (v | (v << 1)) & 0x55
    return spread(qx) | (spread(qy) << 1)


def prep_dir(face_vertices: torch.Tensor, textures: torch.Tensor,
             p: SoftRasParams, for_grad: bool = False) -> DirInputs:
    """The face table of the dir route, plain torch on the device of the
    input: bboxes inflated by sqrt(threshold), the stable Morton order of
    their centres on a 16 x 16 grid (the index breaks ties), the per-face
    rows in that order, the permutation both ways, the union of every 256
    places' bboxes (``window_boxes``) and, ``for_grad``, the backward's work
    items (``bwd_items`` on the CPU, the prep kernel on the card), whose
    count reaches the host without a wait; the card's backward refuses a
    table without them.  The order equals
    ``prep_dir``'s of the JAX package, which sorts only above 128 faces;
    here every mesh is sorted.  The inflation is the border test's own
    float32 sqrt (``border_inflation``), so that the kernels' bbox cull and
    their pair test agree to the bit; the JAX package's float64 sqrt can be
    one ulp away from it."""
    B, F = face_vertices.shape[:2]
    dev = face_vertices.device
    face = face_vertices.reshape(B, F, 9)
    if p.texture_type_id == 0:
        T = textures.shape[2]
        R = math.isqrt(T)
        if R * R != T:
            raise ValueError(f'surface textures need T = R*R texels, got T={T}')
    else:
        R = 1
    sq = border_inflation(p.threshold)
    xs, ys = face[..., 0::3], face[..., 1::3]
    bbox = torch.stack([xs.amin(-1) - sq, xs.amax(-1) + sq,
                        ys.amin(-1) - sq, ys.amax(-1) + sq], dim=-1)
    cx = (bbox[..., 0] + bbox[..., 1]) * 0.5
    cy = (bbox[..., 2] + bbox[..., 3]) * 0.5

    def cell(c):
        return torch.nan_to_num((c + 1.0) * 8.0, nan=0.0).clamp(0, 15).to(torch.int32)

    order = torch.argsort(morton16(cell(cx), cell(cy)), dim=1, stable=True)   # [B, F]
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(F, device=dev).expand(B, F))
    rows = cuda_impl.face_rows(face.gather(1, order[..., None].expand(B, F, 9)),
                               textures.reshape(B, F, -1).gather(
                                   1, order[..., None].expand(B, F, textures[0, 0].numel())), p)
    ids = order.to(torch.int32)
    prep = launch_dir_prep if dev.type == 'cuda' else prep_plain
    sbox, wbox, items = prep(bbox, ids, p.image_size, for_grad)
    return DirInputs(rows, sbox, ids, inv.to(torch.int32), R, wbox, items)


WINDOW = 256    # places a union of window_boxes covers: the forward block's threads


def window_boxes(bbox: torch.Tensor) -> torch.Tensor:
    """[B, ceil(F / 256), 4] the union (least xmin and ymin, largest xmax and
    ymax) of the bboxes of every 256 places of the table, which the forward
    tests before the places themselves.  A face with a NaN in its bbox meets
    no tile and counts in no union; a union of none is empty (+inf, -inf)."""
    B, F = bbox.shape[:2]
    U = -(-F // WINDOW)
    bad = torch.isnan(bbox).any(-1, keepdim=True)
    lo = torch.nn.functional.pad(torch.where(bad, math.inf, bbox[..., 0::2]),
                                 (0, 0, 0, U * WINDOW - F), value=math.inf)
    hi = torch.nn.functional.pad(torch.where(bad, -math.inf, bbox[..., 1::2]),
                                 (0, 0, 0, U * WINDOW - F), value=-math.inf)
    lo = lo.reshape(B, U, WINDOW, 2).amin(2)
    hi = hi.reshape(B, U, WINDOW, 2).amax(2)
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], dim=-1).contiguous()


def bwd_splits(image_size: int) -> int:
    """Items a face's chunks are dealt over, at most: one per SPLIT_PIXELS of
    the image, 1 to MAX_SPLITS."""
    return max(1, min(image_size * image_size // SPLIT_PIXELS, MAX_SPLITS))


def face_pixel_boxes(bbox: torch.Tensor, image_size: int):
    """(c0, c1, r0, r1, ok): each face's pixel bbox on the screen, the pixels
    whose centres may lie in its inflated bbox (rounded outwards), as float
    tensors [B, F], and whether it holds any (a NaN face holds none).  The
    rounding is csrc/softras_grad.cuh's bbox_pixels, operation by
    operation: col = (x * is + is - 1) / 2, row = (is - 1 - y * is) / 2."""
    isf = float(image_size)
    x0, x1, y0, y1 = bbox.unbind(-1)
    c0 = torch.floor((x0 * isf + isf - 1.0) * 0.5).clamp(0.0, isf)
    c1 = torch.ceil((x1 * isf + isf - 1.0) * 0.5).clamp(-1.0, isf - 1.0)
    r0 = torch.floor(((isf - 1.0) - y1 * isf) * 0.5).clamp(0.0, isf)
    r1 = torch.ceil(((isf - 1.0) - y0 * isf) * 0.5).clamp(-1.0, isf - 1.0)
    ok = (x0 <= x1) & (y0 <= y1) & (c0 <= c1) & (r0 <= r1)
    return c0, c1, r0, r1, ok


def face_items(bbox: torch.Tensor, image_size: int, splits: int) -> torch.Tensor:
    """[B, F] i32 each face's work items: min(splits, its chunks of 32
    pixels), 0 for a face with no pixel."""
    c0, c1, r0, r1, ok = face_pixel_boxes(bbox, image_size)
    pixels = torch.where(ok, (c1 - c0 + 1.0) * (r1 - r0 + 1.0), 0.0).to(torch.int32)
    return ((pixels + 31) // 32).clamp(max=splits)


def bwd_items(bbox: torch.Tensor, image_size: int) -> DirItems:
    """The backward's work items of the table's bboxes (in place order), in
    plain torch on their device: each face's count, its offset within its
    unit of 256 places and the units' offsets (``prep_plain`` and the
    prep kernel's rule)."""
    B, F = bbox.shape[:2]
    U = -(-F // WINDOW)
    splits = bwd_splits(image_size)
    n = torch.nn.functional.pad(face_items(bbox, image_size, splits), (0, U * WINDOW - F))
    incl = torch.cumsum(n.reshape(B, U, WINDOW), -1, dtype=torch.int32)
    loff = (incl - n.reshape(B, U, WINDOW)).reshape(B, U * WINDOW)[:, :F].reshape(-1)
    uoff = torch.nn.functional.pad(torch.cumsum(incl[..., -1].reshape(-1), 0,
                                                dtype=torch.int32), (1, 0))
    done = torch.zeros(B * F, dtype=torch.int32, device=bbox.device)
    return DirItems(uoff, loff.contiguous(), done, uoff[-1:].cpu(), None, splits, image_size)


def item_offsets(items: DirItems, B: int, F: int) -> torch.Tensor:
    """[B * F + 1] each face's first item in the whole list, the count
    last: the unit's offset plus the face's within it."""
    place = torch.arange(B * F, device=items.loff.device)
    unit = (place // F) * (-(-F // WINDOW)) + (place % F) // WINDOW
    return torch.cat([items.uoff[unit] + items.loff, items.uoff[-1:]])


def prep_plain(bbox: torch.Tensor, ids: torch.Tensor, image_size: int, with_items: bool):
    """The plain version of the prep kernel (csrc/softras_dir_prep.cu): the
    bboxes [B,F,4] in place order (gathered by ``ids``, each place's
    original face), the unions of every 256 places (``window_boxes``) and,
    ``with_items``, the backward's work items (``bwd_items``), or None."""
    B, F = ids.shape
    sbox = bbox.gather(1, ids.long()[..., None].expand(B, F, 4)).contiguous()
    return sbox, window_boxes(sbox), bwd_items(sbox, image_size) if with_items else None


class _DirPrepArgs(ctypes.Structure):
    """Mirror of ``softras::DirPrepArgs`` in csrc/softras_dir_prep.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'bbox', 'ids', 'sbox', 'wbox', 'loff', 'uoff', 'done')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'U', 'image_size', 'splits')]


def launch_dir_prep(bbox: torch.Tensor, ids: torch.Tensor, image_size: int, with_items: bool):
    """Launch the prep kernel on the current stream: what ``prep_plain``
    returns, in one launch; the items' count is copied to pinned host
    memory behind an event, so nothing waits for it here.
    ``launch_dir_prep.launches`` counts the launches."""
    dev = bbox.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    B, F = ids.shape
    if not 1 <= B <= 65535:
        raise ValueError(f'the kernels take 1 to 65,535 batch elements, got {B}')
    _check(bbox, 'bbox', torch.float32, (B, F, 4), dev)
    _check(ids, 'ids', torch.int32, (B, F), dev)
    U = -(-F // WINDOW)
    splits = bwd_splits(image_size)
    sbox = torch.empty_like(bbox)
    wbox = torch.empty((B, U, 4), dtype=torch.float32, device=dev)
    loff = uoff = done = None
    if with_items:
        loff = torch.empty(B * F, dtype=torch.int32, device=dev)
        uoff = torch.empty(B * U + 1, dtype=torch.int32, device=dev)
        done = torch.empty(B * F, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _DirPrepArgs(bbox.data_ptr(), ids.data_ptr(), sbox.data_ptr(), wbox.data_ptr(),
                        ptr(loff), ptr(uoff), ptr(done), B, F, U, image_size, splits)
    _run(_entry('softras_dir_prep', 'softras_dir_prep', _DirPrepArgs), 'softras_dir_prep', args,
         dev)
    launch_dir_prep.launches += 1
    if not with_items:
        return sbox, wbox, None
    count = torch.empty(1, dtype=torch.int32, pin_memory=True)
    count.copy_(uoff[-1:], non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return sbox, wbox, DirItems(uoff, loff, done, count, ready, splits, image_size)


launch_dir_prep.launches = 0


def item_count(items: DirItems) -> int:
    """The number of work items, on the host: waits on the prep's event
    alone (``item_count.wait_ms`` keeps how long, host clock)."""
    t0 = time.perf_counter()
    if items.ready is not None:
        items.ready.synchronize()
    item_count.wait_ms = (time.perf_counter() - t0) * 1e3
    return int(items.count[0])


item_count.wait_ms = 0.0


def table_faces(inputs: DirInputs, p: SoftRasParams):
    """(face [B,F,9], textures [B,F,T,3] or [B,F,3,3]) of the Morton table."""
    rows = inputs.rows
    B, F = rows.shape[:2]
    tex = rows[..., ROW_BASE:]
    tex = tex.reshape(B, F, -1, 3) if p.texture_type_id == 0 else tex.reshape(B, F, 3, 3)
    return rows[..., :9], tex


def _tex_shape(p: SoftRasParams, B: int, F: int, R: int):
    return (B, F, R * R, 3) if p.texture_type_id == 0 else (B, F, 3, 3)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def fwd_plain(inputs: DirInputs, p: SoftRasParams, with_thr: bool,
              chunk_pairs: int = torch_impl.CHUNK_PAIRS):
    """The plain version of the forward kernel: the Morton table and original
    ids in, pixel-order maps out.  The bboxes, which the kernel culls with,
    change no result of a finite face: their test is the pair's own border
    test (a NaN face, which the kernels cull, poisons the plain versions, as
    on the binned route).  Returns (images [B,4,H,W], aggrs
    [B,2,H,W], counts [B,H,W] int32, thr [B,H,W] or None); the hard
    z-buffer breaks depth ties by the lowest original id and reports it."""
    face, tex = table_faces(inputs, p)
    B = face.shape[0]
    is_ = p.image_size
    xp, yp = torch_impl.pixel_grid(is_, face.device)
    col, ag, cnt = torch_impl.forward_pixels(face, tex, p, xp, yp, chunk_pairs,
                                             ids=inputs.ids)
    thr = None
    if with_thr:
        thr = torch_impl.topk_threshold(face, p, xp, yp, chunk_pairs).reshape(B, is_, is_)
    return (col.permute(0, 2, 1).reshape(B, 4, is_, is_),
            ag.permute(0, 2, 1).reshape(B, 2, is_, is_), cnt.reshape(B, is_, is_), thr)


def bwd_plain(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams,
              chunk_pairs: int = torch_impl.CHUNK_PAIRS // 4):
    """The plain version of the backward kernel: gradients summed at the
    Morton places, then un-permuted through ``inv``.  Returns
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]) in
    the original order."""
    face, tex = table_faces(inputs, p)
    B, F = face.shape[:2]
    xp, yp = torch_impl.pixel_grid(p.image_size, face.device)

    def flat(x):
        return x.reshape(B, x.shape[1], -1).permute(0, 2, 1)

    gf, gt = torch_impl.backward_pixels(
        face, tex, flat(images), flat(aggrs), flat(grad_images), p, xp, yp,
        None if thr is None else thr.reshape(B, -1), chunk_pairs=chunk_pairs,
        ids=inputs.ids)
    back = inputs.inv.long()
    return (gf.gather(1, back[..., None].expand_as(gf)),
            gt.gather(1, back[..., None, None].expand_as(gt)))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def bwd_items_plain(bbox: torch.Tensor, image_size: int, splits: int | None = None):
    """The plain version of the backward's work items: (face [items] int64,
    the place b * F + place of each item's face; split [items] int64), face
    after face and split after split, from the bboxes alone.  ``splits``
    (default ``bwd_splits``) is how many items a face's chunks are dealt
    over, at most."""
    splits = bwd_splits(image_size) if splits is None else splits
    n = face_items(bbox.cpu(), image_size, splits).reshape(-1).long()
    face = torch.repeat_interleave(torch.arange(n.numel()), n)
    first = torch.cumsum(n, 0) - n
    return face, torch.arange(face.numel()) - first[face]


def bwd_split_plain(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams,
                    splits: int | None = None):
    """The plain version of the backward as the kernel splits it: each work
    item's partial row over its pixels (chunks split, split + splits, ... of
    32 pixels of the face's pixel bbox, row-major), then each face's rows
    summed in ascending split order, un-permuted through ``inv``.  Returns
    what ``bwd_plain`` returns; the sums differ from it in their order
    only."""
    face, tex = table_faces(inputs, p)
    B, F = face.shape[:2]
    is_ = p.image_size
    splits = bwd_splits(is_) if splits is None else splits
    c0, c1, r0, r1, _ = (x.cpu() for x in face_pixel_boxes(inputs.bbox, is_))
    fi, sp = bwd_items_plain(inputs.bbox, is_, splits)
    gf = torch.zeros_like(face)
    gt = torch.zeros_like(tex)
    for f_flat, j in zip(fi.tolist(), sp.tolist()):
        b, f = divmod(f_flat, F)
        w = int(c1[b, f] - c0[b, f]) + 1
        npx = w * (int(r1[b, f] - r0[b, f]) + 1)
        k = torch.cat([torch.arange(k0, min(k0 + 32, npx))
                       for k0 in range(32 * j, npx, 32 * splits)]).to(face.device)
        cols = int(c0[b, f]) + k % w
        rows = int(r0[b, f]) + k // w
        xp, yp = torch_impl.pixel_centers(rows, cols, is_)
        g_f, g_t = torch_impl.backward_single(
            face[b, f:f + 1], tex[b, f:f + 1], images[b][:, rows, cols].T,
            aggrs[b][:, rows, cols].T, grad_images[b][:, rows, cols].T, p, xp, yp,
            None if thr is None else thr[b, rows, cols], ids=inputs.ids[b, f:f + 1],
            n_faces=F)
        gf[b, f] = gf[b, f] + g_f[0]          # ascending split order
        gt[b, f] = gt[b, f] + g_t[0]
    back = inputs.inv.long()
    return (gf.gather(1, back[..., None].expand_as(gf)),
            gt.gather(1, back[..., None, None].expand_as(gt)))


def warp_cull_plain(bbox: torch.Tensor, image_size: int) -> torch.Tensor:
    """The plain version of the forward's warp cull: [B, F, H / 4, W / 8]
    whether the warp of pixel rows 4i .. 4i + 3 and columns 8j .. 8j + 7
    keeps the face, by its inflated bbox against the warp's extreme pixel
    centres (the plain version's formulas, monotone in the row and the
    column).  A NaN face is kept by no warp."""
    dev = bbox.device
    c = torch.arange(0, image_size, 8, device=dev)
    r = torch.arange(0, image_size, 4, device=dev)
    x0, _ = torch_impl.pixel_centers(r[:1], c, image_size)
    x1, _ = torch_impl.pixel_centers(r[:1], c + 7, image_size)
    _, y1 = torch_impl.pixel_centers(r, c[:1], image_size)
    _, y0 = torch_impl.pixel_centers(r + 3, c[:1], image_size)
    q = bbox[..., None, None, :]
    return ((q[..., 0] <= x1) & (q[..., 1] >= x0)
            & (q[..., 2] <= y1[:, None]) & (q[..., 3] >= y0[:, None]))


# --------------------------------------------------------------------------
# the kernels' wrappers and builds
# --------------------------------------------------------------------------

class _DirFwdArgs(ctypes.Structure):
    """Mirror of ``softras::DirFwdArgs`` in csrc/softras_dir_fwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'bbox', 'wbox', 'ids', 'image', 'aggrs', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'row', 'image_size', 'tiles', 'chunk', 'wchunk', 'warp_rows', 'K',
            'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


class _DirBwdArgs(ctypes.Structure):
    """Mirror of ``softras::DirBwdArgs`` in csrc/softras_dir_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'bbox', 'ids', 'uoff', 'loff', 'image', 'aggrs', 'grad', 'thr', 'part', 'done',
        'grad_face', 'grad_tex')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'U', 'row', 'image_size', 'splits', 'GC', 'items',
            'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


# the forward block's shared memory besides its chunk of rows and ids: the
# list of up to 4 x 256 places and 4 x 8 warp counts
FWD_RESERVED_BYTES = 4 * (4 * 256 + 4 * 8)
# the same where warps stage their own rows: the list and counts, each
# warp's 32 kept places and their ids
FWD_WARP_RESERVED_BYTES = 4 * (4 * 256 + 4 * 8 + 8 * 64)
FWD_WARP_CHUNK = 8      # rows a warp stages at once, at most
# below this many image pixels a face, the forward's warps cull the tile's
# list and stage their own rows (fwd_warp_rows)
WARP_ROWS_PIXELS = 32


def fwd_warp_chunk(row: int) -> int:
    """Rows each of the forward's 8 warps stages at once (warp rows)."""
    return max(1, min(FWD_WARP_CHUNK,
                      (cuda_impl.SMEM_BYTES - FWD_WARP_RESERVED_BYTES) // (8 * 4 * row)))


def fwd_warp_rows(F: int, image_size: int) -> bool:
    """Whether the forward's warps cull the tile's list and stage their own
    rows: where faces are small beside a tile, fewer than WARP_ROWS_PIXELS
    image pixels a face (demo 2's 64-px views of 1,300 faces, the 39,474-face
    sphere at 1024 px), a warp's 8 x 4 pixels meet a small share of the
    tile's faces; where they are large (the 288- and 3,330-face spheres at
    1024 px) every warp needs most of them, and the block stages them once.
    The crossover lies between 27 and 44 pixels a face (PERF.md §6)."""
    return image_size * image_size < WARP_ROWS_PIXELS * F


def _check_inputs(inputs: DirInputs, p: SoftRasParams):
    """Table, bboxes and ids on one card, of the types, shapes and layout the
    kernels index.  Returns (device, B, F, row)."""
    rows = inputs.rows
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, row], got {tuple(rows.shape)}')
    B, F, row = rows.shape
    R = inputs.tex_res
    expect = 3 * R * R if p.texture_type_id == 0 else 9
    if row - ROW_BASE != expect:
        raise ValueError(f'rows hold {row - ROW_BASE} texture values, expected {expect}')
    if not 1 <= B <= 65535:
        raise ValueError(f'the kernels take 1 to 65,535 batch elements, got {B}')
    if not dir_tile(p.image_size):
        raise ValueError(f'the dir route takes sizes divisible by 8, got {p.image_size}')
    _check(rows, 'rows', torch.float32, (B, F, row), dev)
    _check(inputs.bbox, 'bbox', torch.float32, (B, F, 4), dev)
    _check(inputs.ids, 'ids', torch.int32, (B, F), dev)
    return dev, B, F, row


def fwd_args(inputs: DirInputs, p: SoftRasParams, with_thr: bool,
             warp_rows: bool | None = None):
    """The forward kernel's checked arguments and its outputs (images
    [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32, thr [B,H,W] or None),
    allocated on the inputs' card: what ``launch_dir_fwd`` hands to the
    kernel.  ``warp_rows`` (default ``fwd_warp_rows``) chooses how the
    listed rows are staged."""
    dev, B, F, row = _check_inputs(inputs, p)
    if with_thr and p.max_faces_id < 1:
        raise ValueError(f'K must be at least 1, got {p.max_faces_id}')
    _check(inputs.wbox, 'wbox', torch.float32, (B, -(-F // WINDOW), 4), dev)
    is_ = p.image_size
    images = torch.empty((B, 4, is_, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, is_, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, is_, is_), dtype=torch.int32, device=dev)
    thr = torch.empty((B, is_, is_), dtype=torch.float32, device=dev) if with_thr else None
    args = _DirFwdArgs(
        inputs.rows.data_ptr(), inputs.bbox.data_ptr(), inputs.wbox.data_ptr(),
        inputs.ids.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), counts.data_ptr(),
        None if thr is None else thr.data_ptr(), B, F, row, is_,
        -(-is_ // cuda_impl.TILE), cuda_impl.chunk_for(row, FWD_RESERVED_BYTES),
        fwd_warp_chunk(row), int(fwd_warp_rows(F, is_) if warp_rows is None else warp_rows),
        p.max_faces_id if with_thr else 0,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, inputs.tex_res))
    return args, (images, aggrs, counts, thr)


def _occupancy(source: str, args_type, args) -> dict:
    fn = getattr(_build.load(source), f'{source}_occupancy')
    fn.argtypes = [ctypes.POINTER(args_type), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(ctypes.byref(args), out)
    if err != 0:
        raise RuntimeError(f'{source} occupancy query failed: CUDA error {err}')
    return {'registers': out[0], 'local_bytes': out[1], 'blocks_per_sm': out[2]}


def fwd_occupancy(args) -> dict:
    """Registers, local (spill) bytes and blocks an SM of the forward kernel
    that ``args`` (``fwd_args``) launch."""
    return _occupancy('softras_dir_fwd', _DirFwdArgs, args)


def launch_dir_fwd(inputs: DirInputs, p: SoftRasParams, with_thr: bool):
    """Launch the dir forward kernel on the current stream.  Returns
    (images [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32, thr [B,H,W] or
    None); the threshold, the K-th smallest candidate depth (K =
    ``p.max_faces_id``) and ``far`` where a pixel has at most K candidates,
    comes from the same walk when ``with_thr``.  ``launch_dir_fwd.launches``
    counts the launches."""
    args, out = fwd_args(inputs, p, with_thr)
    _run(_entry('softras_dir_fwd', 'softras_dir_fwd', _DirFwdArgs), 'softras_dir_fwd', args,
         inputs.rows.device)
    launch_dir_fwd.launches += 1
    return out


launch_dir_fwd.launches = 0


def bwd_args(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """The backward kernel's checked arguments and its outputs
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]),
    allocated on the inputs' card with the partial rows (one an item): what
    ``launch_dir_bwd`` hands to the kernel.  The items are the prep's
    (``prep_dir(..., for_grad=True)`` at this image size), waited for
    (``item_count``); a table without them is refused."""
    dev, B, F, row = _check_inputs(inputs, p)
    is_ = p.image_size
    _check(images, 'images', torch.float32, (B, 4, is_, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, is_, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, is_, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, is_, is_), dev)
    R = inputs.tex_res
    GC = cuda_impl._grad_columns(p, R)
    T3 = GC - 9 if p.texture_type_id == 0 else 0
    if 4 * 8 * (row + T3) > SMEM_BYTES:
        raise ValueError(f"{T3} texture values per face do not fit the dir backward "
                         f"kernel's shared memory")
    items = inputs.items
    if items is None or items.image_size != is_:
        raise ValueError(f"the dir backward needs the table's work items at {is_} px: "
                         f"prepare with prep_dir(..., for_grad=True) at this image size")
    U = -(-F // WINDOW)
    _check(items.uoff, 'unit offsets', torch.int32, (B * U + 1,), dev)
    _check(items.loff, 'item offsets', torch.int32, (B * F,), dev)
    _check(items.done, 'face counters', torch.int32, (B * F,), dev)
    n = item_count(items)
    part = torch.empty((n, GC), dtype=torch.float32, device=dev)
    grad_face = torch.empty((B, F, 9), dtype=torch.float32, device=dev)
    grad_tex = torch.empty(_tex_shape(p, B, F, R), dtype=torch.float32, device=dev)
    args = _DirBwdArgs(
        inputs.rows.data_ptr(), inputs.bbox.data_ptr(), inputs.ids.data_ptr(),
        items.uoff.data_ptr(), items.loff.data_ptr(), images.data_ptr(), aggrs.data_ptr(),
        grad_images.data_ptr(), None if thr is None else thr.data_ptr(), part.data_ptr(),
        items.done.data_ptr(), grad_face.data_ptr(), grad_tex.data_ptr(),
        B, F, U, row, is_, items.splits, GC, n, p.dist_func_id, p.rgb_func_id,
        p.alpha_func_id, _scalars(p, R))
    args.keep = (items, part)
    return args, (grad_face, grad_tex)


def bwd_occupancy(args) -> dict:
    """Registers, local (spill) bytes and blocks an SM of the backward
    kernel that ``args`` (``bwd_args``) launch."""
    return _occupancy('softras_dir_bwd', _DirBwdArgs, args)


def launch_dir_bwd(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """Launch the dir backward on the current stream: a warp for each work
    item, which sums its share of the face's pixels into a partial row; the
    face's last item sums its rows in ascending split order into the face's
    original row.  ``thr`` is the threshold map or None (no
    truncation).  Returns (grad_face_vertices [B,F,9], grad_textures
    [B,F,T,3] or [B,F,3,3]).  ``launch_dir_bwd.launches`` counts the calls;
    ``launch_dir_bwd.wait_ms`` is the last call's wait on the item count."""
    args, out = bwd_args(inputs, images, aggrs, thr, grad_images, p)
    launch_dir_bwd.wait_ms = item_count.wait_ms
    _run(_entry('softras_dir_bwd', 'softras_dir_bwd', _DirBwdArgs), 'softras_dir_bwd', args,
         inputs.rows.device)
    launch_dir_bwd.launches += 1
    return out


launch_dir_bwd.launches = 0
launch_dir_bwd.wait_ms = 0.0


# --------------------------------------------------------------------------
# by device
# --------------------------------------------------------------------------

def forward(inputs: DirInputs, p: SoftRasParams, with_thr: bool):
    """(images, aggrs, counts, thr or None) of the dir route: the kernel for
    a CUDA table, the plain version for a CPU one."""
    dev = inputs.rows.device
    if dev.type == 'cpu':
        return fwd_plain(inputs, p, with_thr)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch_dir_fwd(inputs, p, with_thr)


def backward(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures) of the dir route, by device."""
    dev = inputs.rows.device
    if dev.type == 'cpu':
        return bwd_plain(inputs, images, aggrs, thr, grad_images, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch_dir_bwd(inputs, images, aggrs, thr, grad_images.contiguous(), p)
