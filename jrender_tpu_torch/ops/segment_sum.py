"""Sums of rows by segment in a fixed order, with no float atomics on the card.

``index_add_`` adds with float atomics on a CUDA tensor, so the last bits
of its sums change from run to run, where the JAX package promises the
same images and gradients for the same inputs (README "Determinism").  The
port's sums by vertex or by face go through here instead: vertex normals
(``structures/mesh.py``), N3MR's depth gradient (``ops/n3mr/torch_impl.py``)
and the face sums after the pxg, f_px and px_f backward kernels
(``ops/softras/tiled.py``):

  ``segment_order``       a stable sort of the segment ids, made once per
                          call: each segment's rows in ascending place
  ``launch_segment_sum``  the kernel (csrc/segment_sum.cu: a thread per
                          output value adds its segment's rows in that
                          order), for rows of any width
  ``sum_plain``           its plain version, ``index_add_`` on the CPU,
                          which adds the rows one after the other in order
  ``segment_sum``         by device; ``SegmentSum`` is its autograd
                          Function, whose backward gathers (no sum at all)

``launch_segment_sum.launches`` counts the launches.  Rows whose segment
id is at least the segment count are dropped.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .softras.cuda_impl import _check, _entry, _run


class SegmentOrder(NamedTuple):
    seg: torch.Tensor | None   # [N] i64 segment of each row (n_seg and above: dropped);
    #                            only the gradient's gather reads it
    off: torch.Tensor          # [n_seg + 1] i32 first place of each segment in ``order``
    order: torch.Tensor        # [N] i32 row ids by segment, ascending within one
    n_seg: int


def segment_order(seg: torch.Tensor, n_seg: int) -> SegmentOrder:
    """The rows of each segment in ascending order: a stable sort of the
    segment ids (plain torch on their device; no atomics)."""
    seg = seg.reshape(-1).long()
    keys, order = torch.sort(seg, stable=True)
    bounds = torch.arange(n_seg + 1, device=seg.device)
    off = torch.searchsorted(keys, bounds).to(torch.int32)
    return SegmentOrder(seg, off, order.to(torch.int32), n_seg)


def sum_plain(rows: torch.Tensor, so: SegmentOrder) -> torch.Tensor:
    """The plain version: [n_seg, C] sums, each segment's rows added in
    ascending order (``index_add_``, on the CPU)."""
    n = (so.off[1:] - so.off[:-1]).long()
    owner = torch.repeat_interleave(torch.arange(so.n_seg, device=rows.device), n)
    picked = rows[so.order[:owner.numel()].long()]
    return rows.new_zeros((so.n_seg,) + rows.shape[1:]).index_add_(0, owner, picked)


class _SegmentSumArgs(ctypes.Structure):
    """Mirror of ``segsum::SegmentSumArgs`` in csrc/segment_sum.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'off', 'order', 'out')] + \
        [('n_seg', ctypes.c_longlong), ('C', ctypes.c_int)]


def launch_segment_sum(rows: torch.Tensor, so: SegmentOrder) -> torch.Tensor:
    """Launch the kernel on the current stream: [n_seg, C] sums of the
    float32 rows [N, C], each segment's rows added in ascending order.
    ``launch_segment_sum.launches`` counts the launches."""
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 2:
        raise ValueError(f'rows must be [N, C], got {tuple(rows.shape)}')
    N, C = rows.shape
    _check(rows, 'rows', torch.float32, (N, C), dev)
    _check(so.off, 'off', torch.int32, (so.n_seg + 1,), dev)
    _check(so.order, 'order', torch.int32, (N,), dev)
    out = torch.empty((so.n_seg, C), dtype=torch.float32, device=dev)
    fn = _entry('segment_sum', 'segment_sum', _SegmentSumArgs)
    args = _SegmentSumArgs(rows.data_ptr(), so.off.data_ptr(), so.order.data_ptr(),
                           out.data_ptr(), so.n_seg, C)
    _run(fn, 'segment_sum', args, dev)
    launch_segment_sum.launches += 1
    return out


launch_segment_sum.launches = 0


def segment_sum(rows: torch.Tensor, so: SegmentOrder) -> torch.Tensor:
    """[n_seg, C] sums of rows [N, C] by segment in a fixed order: the
    kernel for CUDA rows, the plain version for CPU ones."""
    if rows.device.type == 'cpu':
        return sum_plain(rows, so)
    return launch_segment_sum(rows.contiguous(), so)


class SegmentSum(torch.autograd.Function):
    """``segment_sum`` with its gradient: each row takes its segment's
    incoming gradient (a dropped row none), a gather in fixed order."""

    @staticmethod
    def forward(ctx, rows, so: SegmentOrder):
        ctx.so = so
        return segment_sum(rows, so)

    @staticmethod
    def backward(ctx, grad_out):
        so = ctx.so
        pad = torch.cat([grad_out, grad_out.new_zeros((1,) + grad_out.shape[1:])])
        return pad[so.seg.clamp_max(so.n_seg)], None
