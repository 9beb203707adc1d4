"""The device rule of the package's entry points, and its constants.

An entry point (``Mesh``, ``Renderer``, ``soft_rasterize``) runs on the
card unless its caller passes ``device='cpu'``.  With no device given
and no card present it raises: it never carries on on the CPU unasked.

``device_constant`` puts a Python constant (a light's colour, a camera's
``up``, a background colour) on the device once: ``torch.as_tensor`` of a
tuple onto the card copies from pageable memory and then waits for the
stream, which drains the card at every call.
"""
from __future__ import annotations

import struct

import torch

from .utils.profiling import annotate


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'jrender_tpu_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch version on the CPU")
    return torch.device('cuda')


_PACK_F64 = struct.Struct('<d').pack


def _value_key(x):
    """A key of a Python number, or of a nested tuple or list of them, that
    tells apart any two values whose tensors could differ: a float by its
    bits (so ``-0.0`` and ``0.0``, and NaNs of other bits, stay apart), an
    int by its value.  None for anything else."""
    if isinstance(x, float):
        return _PACK_F64(x)
    if isinstance(x, int):
        return x
    if isinstance(x, (tuple, list)):
        key = tuple([_value_key(v) for v in x])
        return None if None in key else key
    return None


class ConstantCache:
    """Device tensors of Python constants, each copied to its device once.

    ``get`` hands a tensor to ``torch.as_tensor`` as it is (an optimised
    light direction keeps its gradient), and so anything that is not a
    Python number or a nested tuple or list of them.  A Python value is
    kept under its device, the device's current stream, the dtype and
    ``_value_key``.  A miss copies it from pinned host memory without a
    wait, inside a ``jr.const.upload`` span; a hit returns the same tensor
    with no copy.  Past ``capacity`` entries a new value is copied the
    same way and not kept.  Callers share what ``get`` returns and never
    write into it.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.tensors: dict = {}

    def get(self, x, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        value = None if isinstance(x, torch.Tensor) else _value_key(x)
        if value is None:
            return torch.as_tensor(x, dtype=dtype, device=device)
        device = torch.device(device)
        stream = None
        if device.type == 'cuda':
            if device.index is None:
                device = torch.device('cuda', torch.cuda.current_device())
            stream = torch.cuda.current_stream(device).cuda_stream
        key = (device, stream, dtype, value)
        t = self.tensors.get(key)
        if t is None:
            t = _upload(x, device, dtype)
            if len(self.tensors) < self.capacity:
                self.tensors[key] = t
        return t


def _upload(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made outside inference mode: a cached inference tensor could not be
    # saved for a later backward
    with annotate('jr.const.upload'), torch.inference_mode(False):
        t = torch.tensor(x, dtype=dtype)
        if device.type == 'cuda':
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


CONSTANTS = ConstantCache()


def device_constant(x, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, with a Python
    constant taken from the process's ``ConstantCache``."""
    return CONSTANTS.get(x, device, dtype)
