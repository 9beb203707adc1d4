"""The kernels' argument structs and the ``*_args`` functions, on the CPU.

Every wrapper hands its kernel one C struct through ctypes.  Its Python
mirror must lay the fields out as the CUDA source does: each mirror is held
here against the struct as the source declares it (field names, kinds and
order, and the size under C's alignment rules).  The ``*_args`` functions that
time a kernel alone (``reduce_args``, ``texbwd_args``, ``combine_args``,
``edge_bands_args``: arguments made once, outputs allocated) must refuse
what the kernel cannot take: a tensor off the card, of another shape or
type, or on another device than the rest; and fill the struct from the
tensors they were given.  The CPU stands in for the card where a test says
so (``_need_cuda`` accepting it): no kernel is launched here.
"""
import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jrender_tpu_torch.ops import segment_sum
from jrender_tpu_torch.ops.n3mr import cuda_impl as ncuda
from jrender_tpu_torch.ops.n3mr import torch_impl as nplain
from jrender_tpu_torch.ops.softras import (cuda_impl, dir_impl, make_params, pxg_impl,
                                           tiled)
from jrender_tpu_torch.probes import bwd_dma, micro

CSRC = Path(cuda_impl.__file__).resolve().parents[2] / 'csrc'
MIRRORS = [cls for mod in (cuda_impl, pxg_impl, dir_impl, tiled, ncuda, segment_sum, micro,
                            bwd_dma)
           for _, cls in inspect.getmembers(mod, inspect.isclass)
           if issubclass(cls, ctypes.Structure) and (cls.__doc__ or '').startswith('Mirror of')
           and cls.__module__ == mod.__name__]


def c_struct(name: str):
    """The fields of ``struct name`` as a csrc source declares it: a list of
    (field, kind, count), kind 'p' (pointer), 'i' (int), 'u' (unsigned), 'l'
    (long long), 'f' (float) or a nested struct's fields."""
    for path in sorted(CSRC.glob('*.cu*')):
        m = re.search(r'struct\s+' + name + r'\s*\{(.*?)\};', path.read_text(), re.S)
        if m:
            break
    else:
        raise AssertionError(f'no struct {name} in {CSRC}')
    fields = []
    for decl in re.sub(r'//[^\n]*', '', m.group(1)).split(';'):
        decl = ' '.join(decl.split())
        if not decl:
            continue
        t = re.match(r'(?:const )?(long long|unsigned|\w+)\s*(\*?)\s*(.*)', decl)
        base, ptr, names = t.groups()
        for n in names.split(','):
            n = n.strip()
            arr = re.match(r'(\w+)\[(\d+)\]', n)
            n, count = (arr.group(1), int(arr.group(2))) if arr else (n, 1)
            if ptr or n.startswith('*'):
                kind = 'p'
            elif base in ('int', 'float', 'unsigned', 'long long'):
                kind = base[0]
            else:
                kind = c_struct(base)
            fields.append((n.lstrip('*'), kind, count))
    return fields


def c_layout(fields):
    """(size, alignment) of a struct of ``fields`` under C's rules."""
    off, align = 0, 1
    for _, kind, count in fields:
        size, al = (8, 8) if kind in ('p', 'l') else (4, 4) if kind in ('i', 'f', 'u') \
            else c_layout(kind)
        off = -(-off // al) * al + size * count
        align = max(align, al)
    return -(-off // align) * align, align


def mirror_fields(cls):
    out = []
    for n, t in cls._fields_:
        count = getattr(t, '_length_', 1)
        t = getattr(t, '_type_', t) if count > 1 else t
        kind = {ctypes.c_void_p: 'p', ctypes.c_int: 'i', ctypes.c_float: 'f',
                ctypes.c_uint: 'u', ctypes.c_longlong: 'l'}.get(t)
        out.append((n, kind if kind else mirror_fields(t), count))
    return out


@pytest.mark.parametrize('cls', MIRRORS, ids=[c.__name__ for c in MIRRORS])
def test_mirror_lays_out_the_c_struct(cls):
    name = re.match(r'Mirror of ``\w+::(\w+)``', cls.__doc__).group(1)
    want = c_struct(name)
    assert mirror_fields(cls) == want
    assert ctypes.sizeof(cls) == c_layout(want)[0]


def test_every_args_struct_has_a_mirror():
    assert {c.__name__ for c in MIRRORS} >= {'_ReduceArgs', '_TexBwdArgs', '_PxgCombineArgs',
                                             '_EdgeBandArgs'}


# ---- the *_args functions -------------------------------------------------------------

def faces(seed, B, F):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.9, 0.9, (B, F, 3, 2))
    ctr = xy.mean(2, keepdims=True)
    xy = ctr + (xy - ctr) * 0.3
    z = rng.uniform(2.0, 3.0, (B, F, 3, 1))
    return torch.tensor(np.concatenate([xy, z], -1).astype(np.float32).reshape(B, F, 9))


def reduce_case():
    fv = faces(0, 2, 30)
    tex = torch.rand(2, 30, 4, 3, generator=torch.Generator().manual_seed(1))
    p = make_params(image_size=32)
    inputs = cuda_impl.prepare(fv, tex, p, for_grad=True)
    L = inputs.lists.faces_sorted.shape[1]
    rows = cuda_impl.GradRows(torch.zeros(2, L, 21), torch.zeros(2, 30, 21))
    return [inputs, rows, p]


def texbwd_case():
    face = faces(2, 2, 30)
    fi, wt, dp, _, zc = nplain.forward_maps(face, 32, 0.1, 100.0)
    g = torch.randn(wt.shape, generator=torch.Generator().manual_seed(3))
    return [nplain.face_rows(face, 32), (2, 30, 4, 4, 4, 3), fi, wt, dp, zc, g, 1e-3]


def combine_case():
    fv = faces(4, 1, 30)
    tex = torch.rand(1, 30, 4, 3, generator=torch.Generator().manual_seed(5))
    p = make_params(image_size=32)
    pin = pxg_impl.prep_pxg(fv, tex, p)
    return [pin, torch.zeros(pin.items.shape[0], pxg_impl.PARTS, pxg_impl.PIXELS), p]


def edge_bands_case():
    return [torch.zeros(2, 30, 7), 32]


def reduce_fields(case, args, out):
    inputs, rows, p = case
    cl = inputs.lists
    ptrs = (rows.gslots, rows.gbig, cl.gsrc, cl.gpos, *out)
    ints = (2, 30, cl.faces_sorted.shape[1], cl.faces_sorted.shape[1] // 30, 21)
    assert out[0].shape == (2, 30, 9) and out[1].shape == (2, 30, 4, 3)
    return ptrs, ints, ('B', 'F', 'L', 'mt', 'GC')


def texbwd_fields(case, args, out):
    rows, shape, fi, wt, dp, zc, g, eps = case
    assert out.shape == shape and args.eps == pytest.approx(eps)
    return (rows, fi, wt, dp, zc, g, out), (2, 30, 32, 4), ('B', 'F', 'image_size', 'ts')


def combine_fields(case, args, out):
    pin, parts, p = case
    assert [tuple(x.shape) for x in out] == [(1, 4, 32, 32), (1, 2, 32, 32), (1, 32, 32)]
    assert args.s.near == pytest.approx(p.near) and args.s.far == pytest.approx(p.far)
    return ((parts, pin.item_off, *out), (1, 30, 32, pxg_impl.tiles_for(32), p.rgb_func_id,
                                          p.alpha_func_id),
            ('B', 'F', 'image_size', 'tiles_x', 'rgb_func', 'alpha_func'))


def edge_bands_fields(case, args, out):
    pp, is_ = case
    keys, items = out
    assert keys.shape == (6 * 2 * 30 * ncuda.EDGE_SPAN,) and items.shape == (6 * 2 * 30, 3)
    assert keys.dtype == ncuda.key_dtype(2, 30, is_)
    return (pp, keys, items), (2, 30, is_, keys.element_size()), ('B', 'F', 'image_size',
                                                                  'key_bytes')


# the function, its case, the check of the struct it fills, and the case broken
# three ways: the argument at an index replaced by a tensor of another shape,
# of another type, on another device
ARGS_FNS = {
    'reduce_args': (cuda_impl.reduce_args, reduce_case, reduce_fields, {
        'shape': (1, lambda c: c[1]._replace(gbig=c[1].gbig[:, :5])),
        'dtype': (1, lambda c: c[1]._replace(gslots=c[1].gslots.double())),
        'device': (1, lambda c: c[1]._replace(gslots=c[1].gslots.to('meta')))}),
    'texbwd_args': (ncuda.texbwd_args, texbwd_case, texbwd_fields, {
        'shape': (6, lambda c: c[6][:, :, :5]),
        'dtype': (4, lambda c: c[4].double()),
        'device': (2, lambda c: c[2].to('meta'))}),
    'combine_args': (pxg_impl.combine_args, combine_case, combine_fields, {
        'shape': (1, lambda c: c[1][:, :4]),
        'dtype': (1, lambda c: c[1].double()),
        'device': (1, lambda c: c[1].to('meta'))}),
    'edge_bands_args': (ncuda.edge_bands_args, edge_bands_case, edge_bands_fields, {
        'shape': (0, lambda c: c[0][..., :6]),
        'dtype': (0, lambda c: c[0].double()),
        'device': (0, lambda c: c[0].to('meta'))}),
}


@pytest.fixture
def cpu_as_card(monkeypatch):
    """The CPU passes the card check of the *_args functions (any other device does not):
    their other checks and the struct they fill can be read without a
    card."""
    need = cuda_impl._need_cuda
    monkeypatch.setattr(cuda_impl, '_need_cuda', lambda dev: None if dev.type == 'cpu'
                        else need(dev))


@pytest.mark.parametrize('name', list(ARGS_FNS))
def test_args_fn_refuses_a_tensor_off_the_card(name):
    build, case = ARGS_FNS[name][:2]
    with pytest.raises(ValueError, match='CUDA'):
        build(*case())


@pytest.mark.parametrize('name', list(ARGS_FNS))
def test_args_fn_fills_its_struct(name, cpu_as_card):
    build, case_fn, fields = ARGS_FNS[name][:3]
    case = case_fn()
    args, out = build(*case)
    ptrs, ints, int_names = fields(case, args, out)
    struct = type(args)
    assert struct in MIRRORS
    pointer_names = [n for n, t in struct._fields_ if t is ctypes.c_void_p]
    assert [getattr(args, n) for n in pointer_names] == [t.data_ptr() for t in ptrs]
    assert tuple(getattr(args, n) for n in int_names) == ints
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == 'cpu' and t.is_contiguous()


@pytest.mark.parametrize('how', ['shape', 'dtype', 'device'])
@pytest.mark.parametrize('name', list(ARGS_FNS))
def test_args_fn_refuses_wrong_inputs(name, how, cpu_as_card):
    build, case_fn, _, broken = ARGS_FNS[name]
    case = case_fn()
    at, breaker = broken[how]
    case[at] = breaker(case)
    with pytest.raises(TypeError if how == 'dtype' else ValueError):
        build(*case)
