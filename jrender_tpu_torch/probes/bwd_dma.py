"""T2: what staging a backward work item costs.

Counterpart of ``tools/exp_bwd_dma.py`` ``build`` (:31, its ``pallas_call``
at :99), at the tile backward's shapes.  ``N`` items; item i reads its face
block ``face[i]`` [106, 128] and writes its gradient block ``gout[i]``
[84, 128], every row of which is s[l] = sum_t acc[t, l] over T2 = 256
pixels, with (slab[c, g, t] = px[seg[16 i + g], c, t]):

  ``base``   acc[t, l] = face[i, 0, l] * 1e-6
  ``dma16``  base, after the 16 groups' px rows are copied (16 copies)
  ``dma1r``  base, after the 18 rows px[seg[16 i] : +18] are copied (one copy)
  ``tr256``  dma16, + slab[l // 16, l % 16, t] * 1e-6 (the slab transposed)
  ``dots``   tr256, + sum_{c < 11} slab[c, l // 8, t] (11 products with the
             0/1 matrix em[g, l] = (l // 8 == g))

The TPU probe's sixth variant, ``tr256x11``, reshapes 16 values into 256
(``exp_bwd_dma.py:60-63``) and does not trace: it is not defined by the
reference and has no counterpart (``UNDEFINED``).  Each item also gives
``stage_sum[i]``, the uint32 sum (wrapping, stored as int32) of the bits
of every float the item staged (the 16 or 18 px rows; 0 for base), so
that no copy is dead.

  ``launch_bwd_dma``  csrc/probe_bwd_dma.cu (a block per item, the rows
                      through a ring of 16-KB chunks: cp.async for the
                      16-copy variants, TMA bulk copies for dma1r; the
                      products on the tensor cores, or ``dot='ffma'`` /
                      ``'adds'``, builds of their own)
  ``run_plain``       its plain version, batched over items (acc in the
                      TPU probe's order: face, transpose, products)
  ``run``             by device

``launch_bwd_dma.launches`` counts the launches; no entry point of the
package calls the probe.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..ops.softras.cuda_impl import _c_int, _check, _entry, _run

N = 3973       # items (the TPU probe's N: about the 39,474-face mesh's work items)
NTT = 4096     # px rows the items' groups point into (the TPU probe's NTT)
T2 = 256       # pixels of an item
FB = 128       # lanes of a row
GPI = 16       # groups of an item
NTR = 18       # rows of dma1r's ranged copy
FACE_ROWS = 106
OUT_ROWS = 84
PX_C = 16      # rows c of a px row
VARIANTS = ('base', 'dma16', 'dma1r', 'tr256', 'dots')
UNDEFINED = ('tr256x11',)
SOURCE = 'probe_bwd_dma'
DOTS = {'mma': 0, 'ffma': 1, 'adds': 2}   # the products' builds (PROBE_BWD_DMA_DOT)
PLAIN_CHUNK = 512   # items a pass of the plain version


def dot_defines(dot: str = 'mma'):
    """The macros of the products' build ``dot``: 'mma' (the default build,
    no macro), 'ffma' or 'adds'."""
    if dot not in DOTS:
        raise ValueError(f'dot must be one of {tuple(DOTS)}, got {dot!r}')
    return (('PROBE_BWD_DMA_DOT', DOTS[dot]),) if DOTS[dot] else ()


class BwdDmaOut(NamedTuple):
    gout: torch.Tensor        # [N, 84, 128]
    stage_sum: torch.Tensor   # [N] int32


def _check_variant(variant: str) -> int:
    if variant in UNDEFINED:
        raise ValueError(f'{variant!r} is not defined by the reference: the TPU probe does '
                         'not trace it (exp_bwd_dma.py:60-63)')
    if variant not in VARIANTS:
        raise ValueError(f'variant must be one of {VARIANTS}, got {variant!r}')
    return VARIANTS.index(variant)


def _check_shapes(face: torch.Tensor, px: torch.Tensor, seg: torch.Tensor):
    if face.dim() != 3 or tuple(face.shape[1:]) != (FACE_ROWS, FB) or face.shape[0] < 1:
        raise ValueError(f'face must be [N, {FACE_ROWS}, {FB}], got {tuple(face.shape)}')
    if px.dim() != 3 or tuple(px.shape[1:]) != (PX_C, T2) or px.shape[0] < NTR:
        raise ValueError(f'px must be [rows >= {NTR}, {PX_C}, {T2}], got {tuple(px.shape)}')
    if tuple(seg.shape) != (face.shape[0] * GPI,):
        raise ValueError(f'seg must be [{face.shape[0] * GPI}], got {tuple(seg.shape)}')


def staged_rows(seg: torch.Tensor, variant: str) -> torch.Tensor:
    """[N, rows] the px rows each item stages: its 16 groups' rows, the 18
    rows from its first group's, or none (base)."""
    v = _check_variant(variant)
    n = seg.numel() // GPI
    if v == 0:
        return seg.new_zeros((n, 0))
    if variant == 'dma1r':
        return seg.view(n, GPI)[:, :1] + torch.arange(NTR, device=seg.device, dtype=seg.dtype)
    return seg.view(n, GPI)


def stage_sum_plain(px: torch.Tensor, seg: torch.Tensor, variant: str) -> torch.Tensor:
    """[N] int32: the bits of every staged float summed modulo 2^32."""
    row_bits = px.reshape(px.shape[0], -1).view(torch.int32).long().sum(-1)
    s = row_bits[staged_rows(seg, variant).long()].sum(-1) % (1 << 32)
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def run_plain(face: torch.Tensor, px: torch.Tensor, seg: torch.Tensor,
              variant: str) -> BwdDmaOut:
    """The plain version, ``PLAIN_CHUNK`` items at a time: acc in the TPU probe's
    order (the face term, the transpose, the 11 products one after the
    other), summed over the pixels."""
    _check_shapes(face, px, seg)
    _check_variant(variant)
    n = face.shape[0]
    lanes = torch.arange(FB, device=face.device)
    sums = []
    for i0 in range(0, n, PLAIN_CHUNK):
        i1 = min(n, i0 + PLAIN_CHUNK)
        acc = (face[i0:i1, 0, :] * 1e-6)[:, None, :].expand(i1 - i0, T2, FB)
        if variant in ('tr256', 'dots'):
            slab = px[seg[i0 * GPI:i1 * GPI].long()].view(i1 - i0, GPI, PX_C, T2)  # [n, g, c, t]
            acc = acc + slab[:, lanes % 16, lanes // 16, :].transpose(1, 2) * 1e-6
            if variant == 'dots':
                for c in range(11):
                    acc = acc + slab[:, lanes // 8, c, :].transpose(1, 2)
        sums.append(acc.sum(1))
    s = torch.cat(sums)
    return BwdDmaOut(s[:, None, :].expand(n, OUT_ROWS, FB).contiguous(),
                     stage_sum_plain(px, seg, variant))


class _BwdDmaArgs(ctypes.Structure):
    """Mirror of ``probes::BwdDmaArgs`` in csrc/probe_bwd_dma.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('face', 'px', 'seg', 'gout', 'stage_sum')] + \
        [(n, ctypes.c_int) for n in ('N', 'px_rows', 'variant')]


def bwd_dma_args(face: torch.Tensor, px: torch.Tensor, seg: torch.Tensor, variant: str):
    """The kernel's checked arguments and its outputs (a ``BwdDmaOut``),
    allocated on the inputs' card.  The copies need 16-byte aligned rows;
    the rows that the items read are not checked here (``check_rows``)."""
    dev = face.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    _check_shapes(face, px, seg)
    v = _check_variant(variant)
    n = face.shape[0]
    _check(face, 'face', torch.float32, (n, FACE_ROWS, FB), dev)
    _check(px, 'px', torch.float32, tuple(px.shape), dev)
    _check(seg, 'seg', torch.int32, (n * GPI,), dev)
    for t, what in ((face, 'face'), (px, 'px')):
        if t.data_ptr() % 16:
            raise ValueError(f'{what} must start on a 16-byte boundary for the bulk copies')
    out = BwdDmaOut(torch.empty((n, OUT_ROWS, FB), dtype=torch.float32, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev))
    args = _BwdDmaArgs(face.data_ptr(), px.data_ptr(), seg.data_ptr(), out.gout.data_ptr(),
                       out.stage_sum.data_ptr(), n, px.shape[0], v)
    return args, out


def check_rows(px: torch.Tensor, seg: torch.Tensor):
    """Raise unless every group's row and every ranged copy's 18 rows lie
    in px (one read to the host)."""
    lo, hi = (int(v) for v in torch.stack([seg.min(), seg.max()]).tolist())
    if lo < 0 or hi + NTR > px.shape[0]:
        raise ValueError(f'seg must lie in [0, {px.shape[0] - NTR}], got [{lo}, {hi}]')


def entry(dot: str = 'mma'):
    """The C entry point of the products' build ``dot``; raises if the
    library is another build."""
    lib = _build.load(SOURCE, dot_defines(dot))
    if _c_int(lib, 'probe_bwd_dma_dot') != DOTS[dot]:
        raise RuntimeError(f'{SOURCE}: the library is not the {dot!r} build')
    return _entry(SOURCE, SOURCE, _BwdDmaArgs, lib=lib)


def launch_bwd_dma(face: torch.Tensor, px: torch.Tensor, seg: torch.Tensor, variant: str,
                   dot: str = 'mma') -> BwdDmaOut:
    """Check the rows (``check_rows``) and launch the probe on the current
    stream.  ``launch_bwd_dma.launches`` counts the launches."""
    args, out = bwd_dma_args(face, px, seg, variant)
    check_rows(px, seg)
    _run(entry(dot), SOURCE, args, face.device)
    launch_bwd_dma.launches += 1
    return out


launch_bwd_dma.launches = 0


def run(face: torch.Tensor, px: torch.Tensor, seg: torch.Tensor, variant: str,
        dot: str = 'mma') -> BwdDmaOut:
    """The probe by device: the kernel for CUDA inputs, the plain version
    for CPU ones."""
    if face.device.type == 'cpu':
        return run_plain(face, px, seg, variant)
    return launch_bwd_dma(face, px, seg, variant, dot)


def occupancy(dot: str = 'mma') -> dict:
    """Registers, local (spill) bytes, blocks an SM and the shared memory
    of a block, from the CUDA runtime."""
    lib = _build.load(SOURCE, dot_defines(dot))
    fn = lib.probe_bwd_dma_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_int * 3)()
    err = fn(res)
    if err != 0:
        raise RuntimeError(f'{SOURCE} occupancy query failed: CUDA error {err}')
    return {'registers': res[0], 'local_bytes': res[1], 'blocks_per_sm': res[2],
            'smem': _c_int(lib, 'probe_bwd_dma_smem')}


def inputs(n: int = N, ntt: int = NTT, seed: int = 0, device=None):
    """The TPU probe's inputs, from a numpy generator: face [n, 106, 128]
    and px [ntt + 18, 16, 256] uniform in [0, 1), seg [16 n] sorted rows
    in [0, ntt)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    face = torch.from_numpy(rng.uniform(size=(n, FACE_ROWS, FB)).astype(np.float32))
    px = torch.from_numpy(rng.uniform(size=(ntt + NTR, PX_C, T2)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.randint(0, ntt, size=(n * GPI,))).astype(np.int32))
    return face.to(device), px.to(device), seg.to(device)


def moved_bytes(seg: torch.Tensor, variant: str, n_items: int | None = None) -> dict:
    """Bytes of an item's function: 'once' counts the face blocks, the
    gradient blocks, the distinct px rows read, the row ids and the sums
    once each (the bound's); 'copied' counts every row as each item
    copies it."""
    n = seg.numel() // GPI if n_items is None else n_items
    rows = staged_rows(seg, variant)
    row_b = PX_C * T2 * 4
    fixed = n * (FACE_ROWS + OUT_ROWS) * FB * 4 + 4 * n
    distinct = int(torch.unique(rows).numel()) if rows.numel() else 0
    ids = 4 * seg.numel() if rows.numel() else 0
    return {'once': fixed + ids + distinct * row_b, 'copied': fixed + ids + rows.numel() * row_b}
