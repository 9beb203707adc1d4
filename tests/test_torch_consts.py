"""``device_constant``: Python constants put on their device once.

The helper against ``torch.as_tensor`` (values, dtype, shape), its cache
(a repeat is the same tensor; ``-0.0`` and ``0.0``, and dtypes, key
apart; the cap), and the render path through it: after one call a
``render_mesh`` and its backward upload no constant, leave the cached
ones as they were, and give the images and gradients of plain
``torch.as_tensor`` to the bit.

This file imports neither JAX nor the JAX package.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jrender_tpu_torch as jt
from jrender_tpu_torch import _device
from jrender_tpu_torch._device import ConstantCache, device_constant
from jrender_tpu_torch.utils.primitives import uv_sphere

CPU = torch.device('cpu')
VALUES = [30.0, 2, (0, 1, 0), (0.4, 0.4, 0.4), [1.0, -1.0, 1.0] * 3,
          ((1.0, 2.0), (3.0, 4.0)), [[1, 2, 3]], (1e-5, 1e-4), (True, False), ()]
FLOAT_VALUES = [(float('inf'), -7.5), -0.0, (1e39, -1e-46)]   # past float32's range


class PlainConstants:
    """The cache's interface over plain ``torch.as_tensor``."""

    def get(self, x, device, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)


@pytest.mark.parametrize('x, dtype', [
    *[(x, d) for x in VALUES for d in (torch.float32, torch.float64, torch.int32, torch.int64)],
    *[(x, d) for x in FLOAT_VALUES for d in (torch.float32, torch.float64)]], ids=repr)
def test_matches_as_tensor(x, dtype):
    got = ConstantCache().get(x, CPU, dtype)
    want = torch.as_tensor(x, dtype=dtype, device=CPU)
    assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
    assert torch.equal(got.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8))


def test_default_dtype_is_float32():
    assert device_constant((1, 2, 3), 'cpu').dtype == torch.float32


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_a_tensor_comes_back_as_itself(dtype):
    t = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, requires_grad=True)
    cache = ConstantCache()
    assert cache.get(t, CPU, dtype) is t
    assert not cache.tensors


def test_other_values_go_through_as_tensor():
    cache = ConstantCache()
    a = np.array([1.0, 2.0])
    got = cache.get(a, CPU)
    assert torch.equal(got, torch.as_tensor(a, dtype=torch.float32))
    assert cache.get((np.float32(1.0), 2.0), CPU).tolist() == [1.0, 2.0]
    assert not cache.tensors


def test_a_repeat_is_the_cached_tensor():
    cache = ConstantCache()
    first = cache.get((0.4, 0.4, 0.4), CPU)
    assert cache.get((0.4, 0.4, 0.4), 'cpu') is first
    assert cache.get([0.4, 0.4, 0.4], CPU) is first
    assert len(cache.tensors) == 1


def test_a_miss_opens_an_upload_span_and_a_hit_none():
    cache = ConstantCache()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache.get((0.0, 1.0, 0.0), CPU)
    assert [e.name for e in prof.events()].count('jr.const.upload') == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache.get((0.0, 1.0, 0.0), CPU)
    assert 'jr.const.upload' not in [e.name for e in prof.events()]


def test_signed_zeros_and_nans_key_apart():
    cache = ConstantCache()
    pos, neg = cache.get(0.0, CPU), cache.get(-0.0, CPU)
    assert pos is not neg
    assert math.copysign(1.0, pos.item()) == 1.0 and math.copysign(1.0, neg.item()) == -1.0
    a = cache.get((float('nan'), 1.0), CPU)
    assert torch.isnan(a[0]) and a[1] == 1.0
    assert cache.get((float('nan'), 1.0), CPU) is a
    assert len(cache.tensors) == 3


def test_dtypes_key_apart():
    cache = ConstantCache()
    f32 = cache.get((1.0, 2.0), CPU)
    f64 = cache.get((1.0, 2.0), CPU, torch.float64)
    i32 = cache.get((1.0, 2.0), CPU, torch.int32)
    assert (f32.dtype, f64.dtype, i32.dtype) == (torch.float32, torch.float64, torch.int32)
    assert len({id(f32), id(f64), id(i32)}) == 3 and len(cache.tensors) == 3
    assert cache.get((1.0, 2.0), CPU, torch.float64) is f64


def test_the_cache_stays_within_its_cap():
    cache = ConstantCache(capacity=4)
    kept = [cache.get(float(i), CPU) for i in range(4)]
    for i in range(4, 20):
        t = cache.get(float(i), CPU)
        assert t.item() == float(i)
        assert cache.get(float(i), CPU) is not t        # copied again, not kept
    assert len(cache.tensors) == 4
    assert all(cache.get(float(i), CPU) is t for i, t in enumerate(kept))


def test_a_constant_made_in_inference_mode_can_be_saved_for_backward():
    cache = ConstantCache()
    with torch.inference_mode():
        c = cache.get((5.0, 6.0), CPU)
    assert not c.is_inference()
    w = torch.ones(2, requires_grad=True)
    (w * cache.get((5.0, 6.0), CPU)).sum().backward()
    assert w.grad.tolist() == [5.0, 6.0]


def fit_step(dr_type: str, image_size: int = 32):
    """render_mesh of a UV sphere, a loss on every output and its backward:
    the outputs and the gradients of the vertices and the textures."""
    v, f = uv_sphere(9, 10)
    rng = np.random.RandomState(0)
    shape = (1, f.shape[0], 4, 3) if dr_type == 'softras' else (1, f.shape[0], 2, 2, 2, 3)
    vt = torch.tensor(v[None], requires_grad=True)
    tex = torch.tensor(rng.uniform(size=shape).astype(np.float32), requires_grad=True)
    mesh = jt.Mesh(vt, torch.tensor(f[None]), textures=tex, texture_type='surface',
                   dr_type=dr_type, device='cpu')
    r = jt.Renderer(image_size=image_size, dr_type=dr_type, sigma_val=1e-4, device='cpu')
    r.transform.set_eyes_from_angles(2.732, 20, 60)
    out = r.render_mesh(mesh, mode=None)
    sum(o.sum() for o in out).backward()
    return [o.detach() for o in out] + [vt.grad, tex.grad]


@pytest.mark.parametrize('dr_type', ['softras', 'n3mr'])
def test_render_path_uploads_once_and_renders_as_before(dr_type, monkeypatch):
    monkeypatch.setattr(_device, 'CONSTANTS', ConstantCache())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = fit_step(dr_type)
    uploads = [e.name for e in prof.events()].count('jr.const.upload')
    cached = {k: t.clone() for k, t in _device.CONSTANTS.tensors.items()}
    assert uploads == len(cached) > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        second = fit_step(dr_type)
    assert 'jr.const.upload' not in [e.name for e in prof.events()]
    assert cached.keys() == _device.CONSTANTS.tensors.keys()
    for k, t in _device.CONSTANTS.tensors.items():
        assert torch.equal(t, cached[k]), k

    monkeypatch.setattr(_device, 'CONSTANTS', PlainConstants())
    plain = fit_step(dr_type)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, c) and torch.equal(b, c)
