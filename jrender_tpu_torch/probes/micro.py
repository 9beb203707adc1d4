"""T1: what one grid step of a px_f-style kernel costs.

Counterpart of ``tools/exp_micro.py`` ``build`` (:23, its ``pallas_call``
at :63).  A grid of ``N`` steps; step i reads one [16, 128] block
``data[i]`` and, on [T2, 128] (pixel, face) pairs:

  f  = data[i][0] after ``n_face`` chained ops f * 1.0000001 + 1e-7 * (j + 1)
  x  = f + 1, plus the rows data[i][j % 16] for j < ``n_slice``, then
       ``n_pair`` chained ops x * 1.0000001 + 1e-9
  d  = ``n_dot`` products data[i][0:4] @ x^T, [4, T2], float32
  acc[t] += sum_f x[t, f] + sum_t d[0, t]

and returns acc [T2] after the last step.  The TPU carries acc from step to
step; on the card blocks run in no order, so the kernel writes each step's
row ``partial[i]`` and a second pass adds the rows in step order.  Each step
also gives its four dot rows' sums over the pixels (``dots[i]``), which
the TPU probe leaves unread.

  ``launch_micro``  csrc/probe_micro.cu (a block per step, a thread per
                    pixel; the dots on the tensor cores, 3xTF32, or by
                    FFMA with ``ffma=True``, a build of its own)
  ``run_plain``     its plain version; x does not depend on the pixel, so
                    it computes each step's face row once and broadcasts it;
                    in the kernel's FMAs and order of sums, so that without
                    products it gives the kernel's bits
  ``run``           by device

``launch_micro.launches`` counts the launches; no entry point of the
package calls the probe.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..ops.softras.geometry import fma
from ..ops.softras.cuda_impl import _c_int, _check, _entry, _run

N = 838        # steps of the TPU probe's grid
T2 = 1024      # pixels of a step
FB = 128       # faces of a step
ROWS = 16      # rows of a step's block
SOURCE = 'probe_micro'
FFMA_DEFINES = (('PROBE_MICRO_DOT_FFMA', 1),)

# the TPU probe's cases: name, (n_pair, n_face, n_slice, n_dot, T2)
CASES = (
    ('pair20', (20, 0, 0, 0, 1024)),
    ('pair100', (100, 0, 0, 0, 1024)),
    ('pair300', (300, 0, 0, 0, 1024)),
    ('pair20_face90', (20, 90, 0, 0, 1024)),
    ('pair20_slice90', (20, 0, 90, 0, 1024)),
    ('pair20_dot25', (20, 0, 0, 25, 1024)),
    ('pair100_T2=256', (100, 0, 0, 0, 256)),
    ('pair300_T2=256', (300, 0, 0, 0, 256)),
)


class MicroOut(NamedTuple):
    out: torch.Tensor       # [T2] acc after the last step
    partial: torch.Tensor   # [N, T2] each step's row
    dots: torch.Tensor      # [N, 4] each step's dot rows summed over the pixels


def _check_case(data: torch.Tensor, n_pair: int, n_face: int, n_slice: int, n_dot: int,
                t2: int):
    if data.dim() != 3 or tuple(data.shape[1:]) != (ROWS, FB) or data.shape[0] < 1:
        raise ValueError(f'data must be [N, {ROWS}, {FB}], got {tuple(data.shape)}')
    if min(n_pair, n_face, n_slice, n_dot) < 0:
        raise ValueError(f'op counts must be >= 0, got {(n_pair, n_face, n_slice, n_dot)}')
    if not (32 <= t2 <= 1024 and t2 % 32 == 0):
        raise ValueError(f'T2 must be a multiple of 32 in [32, 1024], got {t2}')


# the kernel's constants, float32
_A = torch.tensor(1.0000001, dtype=torch.float32)
_B_PAIR = torch.tensor(1e-9, dtype=torch.float32)


def run_plain(data: torch.Tensor, n_pair: int, n_face: int, n_slice: int, n_dot: int,
              t2: int = T2) -> MicroOut:
    """The plain version, batched over steps, in the kernel's arithmetic:
    its FMAs rounded once (``geometry.fma``), each pixel's face sum in the
    kernel's order (lane q of a quad adds faces 8k + q and 8k + q + 4 over
    the chunks k, then the quad's sums by two butterflies), the rows added
    in step order as the kernel's second pass adds them.  Without products it gives the
    kernel's bits; the products' sums (tensor cores or FFMA) are in other
    orders."""
    _check_case(data, n_pair, n_face, n_slice, n_dot, t2)
    n = data.shape[0]
    f = data[:, 0, :]
    for j in range(n_face):
        f = fma(f, _A, torch.tensor(1e-7 * (j + 1), dtype=torch.float32))
    x = f + 1.0                                               # [n, FB], every pixel's
    for j in range(n_slice):
        x = x + data[:, j % 16, :]
    for _ in range(n_pair):
        x = fma(x, _A, _B_PAIR)
    d = torch.zeros((n, 4), dtype=data.dtype, device=data.device)
    for _ in range(n_dot):
        d = d + (data[:, 0:4, :] * x[:, None, :]).sum(-1)
    dots = d[:, :, None].expand(n, 4, t2).sum(-1)
    pair = x.view(n, FB // 8, 2, 4)                            # face 8k + 4h + q
    pair = pair[:, :, 0, :] + pair[:, :, 1, :]
    lane = pair[:, 0]
    for k in range(1, FB // 8):
        lane = lane + pair[:, k]
    sx = (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])
    partial = (sx + dots[:, 0])[:, None].expand(n, t2).contiguous()
    out = torch.zeros(t2, dtype=data.dtype, device=data.device)
    for i in range(n):
        out = out + partial[i]
    return MicroOut(out, partial, dots)


class _MicroArgs(ctypes.Structure):
    """Mirror of ``probes::MicroArgs`` in csrc/probe_micro.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('data', 'partial', 'dots', 'out')] + \
        [(n, ctypes.c_int) for n in ('N', 'T2', 'n_pair', 'n_face', 'n_slice', 'n_dot')]


def micro_args(data: torch.Tensor, n_pair: int, n_face: int, n_slice: int, n_dot: int,
               t2: int = T2):
    """The kernel's checked arguments and its outputs (a ``MicroOut``),
    allocated on the data's card."""
    dev = data.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    _check_case(data, n_pair, n_face, n_slice, n_dot, t2)
    n = data.shape[0]
    _check(data, 'data', torch.float32, (n, ROWS, FB), dev)
    out = MicroOut(torch.empty(t2, dtype=torch.float32, device=dev),
                   torch.empty((n, t2), dtype=torch.float32, device=dev),
                   torch.empty((n, 4), dtype=torch.float32, device=dev))
    args = _MicroArgs(data.data_ptr(), out.partial.data_ptr(), out.dots.data_ptr(),
                      out.out.data_ptr(), n, t2, n_pair, n_face, n_slice, n_dot)
    return args, out


def entry(ffma: bool = False):
    """The C entry point of the default build (dots on the tensor cores) or
    of the FFMA build; raises if the library is the other build."""
    lib = _build.load(SOURCE, FFMA_DEFINES if ffma else ())
    if _c_int(lib, 'probe_micro_dot_ffma') != int(ffma):
        raise RuntimeError(f'{SOURCE}: the library is not the {"FFMA" if ffma else "default"} build')
    return _entry(SOURCE, SOURCE, _MicroArgs, lib=lib)


def launch_micro(data: torch.Tensor, n_pair: int, n_face: int, n_slice: int, n_dot: int,
                 t2: int = T2, ffma: bool = False) -> MicroOut:
    """Launch the probe on the current stream (the step kernel, then the
    sum in step order).  ``launch_micro.launches`` counts the launches."""
    args, out = micro_args(data, n_pair, n_face, n_slice, n_dot, t2)
    _run(entry(ffma), SOURCE, args, data.device)
    launch_micro.launches += 1
    return out


launch_micro.launches = 0


def run(data: torch.Tensor, n_pair: int, n_face: int, n_slice: int, n_dot: int,
        t2: int = T2, ffma: bool = False) -> MicroOut:
    """The probe by device: the kernel for CUDA data, the plain version
    for CPU data."""
    if data.device.type == 'cpu':
        return run_plain(data, n_pair, n_face, n_slice, n_dot, t2)
    return launch_micro(data, n_pair, n_face, n_slice, n_dot, t2, ffma)


def occupancy(t2: int = T2, ffma: bool = False) -> dict:
    """Registers, local (spill) bytes and blocks an SM of the step kernel at
    ``t2`` threads a block, from the CUDA runtime."""
    fn = getattr(_build.load(SOURCE, FFMA_DEFINES if ffma else ()), 'probe_micro_occupancy')
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_int * 3)()
    err = fn(t2, res)
    if err != 0:
        raise RuntimeError(f'{SOURCE} occupancy query failed: CUDA error {err}')
    return {'registers': res[0], 'local_bytes': res[1], 'blocks_per_sm': res[2]}


def work(n_pair: int, n_face: int, n_slice: int, n_dot: int, t2: int = T2, n: int = N):
    """(float32 operations, bytes) of the probe's function: per pair an FMA
    of each op of the chain (2), a slice add each and the 1 and the face
    sum (2); per face 2 an op of the face chain; 2 * 4 * FB * T2 a
    product; the data read once and ``out`` and ``dots`` written once."""
    ops = n * (t2 * FB * (2 * n_pair + n_slice + 2) + 2 * n_face * FB + n_dot * 8 * FB * t2)
    return ops, 4 * (n * ROWS * FB + t2 + 4 * n)
