"""The Hopper probes' plain versions against the TPU probes, on the CPU.

T1 (``jrender_tpu_torch/probes/micro.py``) against ``tools/exp_micro.py``
and T2 (``probes/bwd_dma.py``) against ``tools/exp_bwd_dma.py``: the TPU
probes' kernels run in Pallas interpret mode (``pallas_call`` wrapped to
pass ``interpret=True``), on inputs made with numpy from a seed, at a tiny
size: the tool modules' ``N`` (and ``NTT``) set by ``monkeypatch``, T1's
``T2`` passed to ``build`` (its default binds when the function is
defined).  T1's output [T2] and T2's whole gradient block ``gout`` (taken
from the wrapped ``pallas_call`` under ``jax.disable_jit``, not the scalar
that the probe's ``run`` returns) must agree within rtol 1e-5: both sides
compute in float32, in other orders (XLA on the CPU contracts
multiply-adds and sums in its own order; T1's plain version does the CUDA
kernel's FMAs, each rounded once, and its sums in the kernel's order, T2's
sums acc over the pixels with torch.sum).  That FMA, ``geometry.fma``, is
held to the exactly rounded multiply-add (fractions) bit for bit.
T2's checksum of the staged bits is held to a loop over the staged rows,
exactly.  The TPU probe's ``tr256x11`` does not trace, and T3 reads names
that ``pallas_impl`` no longer defines; a test shows each.

T3 (``tools/profile_torch_bwd.py``): its stage functions on the CPU, on
its 288-face sphere at 64 px: K6's rows and the face sum give
``pxf_impl.backward``'s gradients bit for bit, and so does the px_f
``soft_rasterize`` step.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as jax_pallas
import numpy as np
import pytest
import torch

from jrender_tpu_torch.ops.softras import pxf_impl, route
from jrender_tpu_torch.probes import bwd_dma, micro

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _tool(name):
    """A module of tools/ by its file (tools/ is not a package)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(f'_tool_{name}', REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def interpret(monkeypatch):
    """pallas_call in interpret mode; returns the list that collects each
    call's outputs."""
    seen = []
    pallas_call = jax_pallas.pallas_call

    def wrapped(*a, **k):
        fn = pallas_call(*a, **{**k, 'interpret': True})

        def call(*args):
            out = fn(*args)
            seen.append(out)
            return out
        return call

    monkeypatch.setattr(jax_pallas, 'pallas_call', wrapped)
    return seen


@pytest.mark.parametrize('name,case', micro.CASES, ids=[c[0] for c in micro.CASES])
def test_micro_plain_matches_the_tpu_probe(name, case, interpret, monkeypatch):
    exp_micro = _tool('exp_micro')
    n, t2 = 3, 64
    monkeypatch.setattr(exp_micro, 'N', n)
    n_pair, n_face, n_slice, n_dot, _ = case
    data = np.random.RandomState(7).uniform(size=(n, micro.ROWS, micro.FB)).astype(np.float32)
    want = np.asarray(exp_micro.build(n_pair, n_face, n_slice, n_dot, T2=t2)(data))[:, 0]
    got = micro.run(torch.from_numpy(data), n_pair, n_face, n_slice, n_dot, t2)
    assert got.out.shape == (t2,) and got.partial.shape == (n, t2) and got.dots.shape == (n, 4)
    np.testing.assert_allclose(got.out.numpy(), want, rtol=RTOL, atol=0)
    # the rows add up to out in step order; the dot rows are 0 without products
    torch.testing.assert_close(got.partial.sum(0), got.out, rtol=RTOL, atol=0)
    assert (got.dots.abs().sum() > 0) == (n_dot > 0)


@pytest.mark.parametrize('b', [1e-9, 1e-7, 9e-6])
def test_fma_rounds_once(b):
    """``geometry.fma``, T1's plain version's FMA, is fmaf: the exact
    x * a + b rounded once to float32 (ties to even), on uniform values and
    on values next to the half-ulp boundaries of T1's pair chain; the
    plain rounding of the product and then of the sum differs on some of
    them."""
    from fractions import Fraction
    from jrender_tpu_torch.ops.softras.geometry import fma
    a, b = np.float32(1.0000001), np.float32(b)
    xs = np.concatenate([
        np.random.RandomState(5).uniform(0, 50, 500),
        1.5 + np.arange(-300, 300) * 2.0 ** -23]).astype(np.float32)
    got = fma(torch.from_numpy(xs), torch.tensor(a), torch.tensor(b)).numpy()
    want = []
    for x in xs:
        v = Fraction(float(x)) * Fraction(float(a)) + Fraction(float(b))
        near = np.float32(float(v))
        cands = (np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf)))
        want.append(min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                              int(np.array(c).view(np.int32)) & 1)))
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    unfused = xs * a + b
    assert (unfused.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize('variant', bwd_dma.VARIANTS)
def test_bwd_dma_plain_matches_the_tpu_probe(variant, interpret, monkeypatch):
    exp_bwd_dma = _tool('exp_bwd_dma')
    n, ntt = 4, 8
    monkeypatch.setattr(exp_bwd_dma, 'N', n)
    monkeypatch.setattr(exp_bwd_dma, 'NTT', ntt)
    face, px, seg = bwd_dma.inputs(n, ntt, seed=3)
    run = exp_bwd_dma.build(variant)
    with jax.disable_jit():
        run(seg.numpy(), np.full((1,), n, np.int32), face.numpy(), px.numpy())
    (gout,) = interpret[-1]
    got = bwd_dma.run(face, px, seg, variant)
    assert got.gout.shape == (n, bwd_dma.OUT_ROWS, bwd_dma.FB)
    np.testing.assert_allclose(got.gout.numpy(), np.asarray(gout), rtol=RTOL, atol=0)
    assert got.stage_sum.dtype == torch.int32 and got.stage_sum.shape == (n,)


@pytest.mark.parametrize('variant', bwd_dma.VARIANTS)
def test_bwd_dma_stage_sum_counts_every_staged_float(variant):
    face, px, seg = bwd_dma.inputs(5, 9, seed=4)
    got = bwd_dma.run_plain(face, px, seg, variant).stage_sum
    bits = px.numpy().view(np.uint32)
    s = seg.numpy()
    want = []
    for i in range(5):
        rows = {'base': [], 'dma1r': list(range(s[16 * i], s[16 * i] + bwd_dma.NTR))}.get(
            variant, list(s[16 * i:16 * i + 16]))
        want.append(int(sum(int(bits[r].astype(np.uint64).sum()) for r in rows) % (1 << 32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.array(want, np.uint32))


def test_tr256x11_is_not_defined_by_the_reference(interpret, monkeypatch):
    exp_bwd_dma = _tool('exp_bwd_dma')
    monkeypatch.setattr(exp_bwd_dma, 'N', 2)
    face, px, seg = bwd_dma.inputs(2, 4, seed=3)
    with pytest.raises(TypeError, match='reshape'):
        with jax.disable_jit():
            exp_bwd_dma.build('tr256x11')(seg.numpy(), np.full((1,), 2, np.int32),
                                          face.numpy(), px.numpy())
    with pytest.raises(ValueError, match='not defined by the reference'):
        bwd_dma.run(face, px, seg, 'tr256x11')


def test_profile_bwd_reads_what_pallas_impl_no_longer_defines():
    """T3 (tools/profile_bwd.py) builds its grid from ``pallas_impl._scal7_spec``
    with seven prefetched scalars (:133-136) and its pixel rows as [B, NT,
    BWD_PC, T2] (:99-100); the px_f backward now takes nine scalars
    (``_scal9_spec``, pallas_impl.py:1523, :1696) and rows [B, NT, T2,
    BWD_PC] (:1671-1672).  So T3 no longer runs against the JAX package; its
    port times the port's own stages around K6."""
    import inspect

    from jrender_tpu.ops.softras import pallas_impl
    assert not hasattr(pallas_impl, '_scal7_spec') and hasattr(pallas_impl, '_scal9_spec')
    tool = (REPO / 'tools' / 'profile_bwd.py').read_text()
    assert 'PI._scal7_spec' in tool and 'reshape(B, NT, BWD_PC, T2)' in tool
    bwd = inspect.getsource(pallas_impl.soft_rasterize_bwd_pallas_pf)
    assert 'num_scalar_prefetch=9' in bwd and 'reshape(B, NT, T2, BWD_PC)' in bwd


def test_probe_wrappers_refuse_bad_inputs():
    data = torch.zeros((2, micro.ROWS, micro.FB))
    with pytest.raises(ValueError, match='multiple of 32'):
        micro.run(data, 1, 0, 0, 0, 48)
    with pytest.raises(ValueError, match='data must be'):
        micro.run(torch.zeros((2, 8, micro.FB)), 1, 0, 0, 0, 64)
    with pytest.raises(ValueError, match='CUDA tensors'):
        micro.launch_micro(data, 1, 0, 0, 0, 64)
    face, px, seg = bwd_dma.inputs(2, 4, seed=3)
    with pytest.raises(ValueError, match='seg must be'):
        bwd_dma.run(face, px, seg[:-1], 'dma16')
    with pytest.raises(ValueError, match='CUDA tensors'):
        bwd_dma.launch_bwd_dma(face, px, seg, 'dma16')
    with pytest.raises(ValueError, match='dot must be'):
        bwd_dma.dot_defines('wgmma')


def test_profile_torch_bwd_stages_equal_the_backward(monkeypatch):
    T3 = _tool('profile_torch_bwd')
    fv, tex, p, g = T3.case(*T3.SPHERES['small'], image_size=64, device='cpu')
    assert fv.shape == (1, 288, 9) and tex.shape == (1, 288, 25, 3)
    pin = T3.prep(fv, tex, p)
    assert pin.face_off is not None and pin.items.shape[0] > 0
    images, aggrs, _, thr = T3.forward(pin, p)
    gf, gt = T3.backward_by_stages(pin, images, aggrs, thr, g, p)
    wf, wt = pxf_impl.backward(pin, images, aggrs, thr, g, p)
    assert torch.equal(gf, wf) and torch.equal(gt, wt)
    assert gf.abs().max() > 0
    # the px_f step: its image is the forward's, its gradients the backward's
    monkeypatch.delenv('JR_LAYOUT', raising=False)
    img_s, sf, st = T3.step(fv, tex, p, g)
    assert route.layout() == 'pxt'
    assert torch.equal(img_s, images)
    assert torch.equal(sf, wf) and torch.equal(st, wt.reshape(st.shape))
