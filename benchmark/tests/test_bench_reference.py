"""The plain references against the port's CPU path at 64 px: the images
of a batch of views and the gradients of a fit step, both configurations.

The port's CPU path is its plain PyTorch version, which evaluates every
pair densely; the references list only the pairs and cells that can touch
and share none of its code, so agreement here is two implementations of
one semantics agreeing."""
import pytest
import torch

from benchmark.harness import check

from conftest import small_cell

CELLS = ['softras_sphere39k_1024.fit8', 'n3mr_sphere39k_1024.fit8']


@pytest.mark.parametrize('name', CELLS)
def test_images_agree(name, torch_threads):
    cell = small_cell(name, views=3)
    cfg = cell.config
    inp = cell.kind_module().make_inputs(cfg, cell.traffic, 11, 'cpu')
    prog = cell.program_module().program(cfg, 'cpu')
    verts = inp.batch(inp.vertices(inp.raw))
    with torch.no_grad():
        out = prog.render(verts, inp.batch(inp.faces), inp.batch(inp.textures), inp.eyes[0])
        ref = cell.reference_module().render(cfg, verts, inp.batch(inp.faces),
                                             inp.batch(inp.textures), inp.eyes[0])
    assert set(ref) == set(cfg['outputs'])
    for k, r in ref.items():
        assert out[k].shape == r.shape
        assert torch.allclose(out[k], r, atol=1e-5, rtol=1e-5), k
    assert check.pixel_share(out, ref) == 0.0


@pytest.mark.parametrize('name', CELLS)
def test_fit_steps_agree(name, torch_threads):
    """Three steps of the fit: losses, first gradients and the leaves'
    change; the gradients entry by entry."""
    cell = small_cell(name)
    cfg, mix = cell.config, cell.traffic
    kind = cell.kind_module()
    inp = kind.make_inputs(cfg, mix, 12, 'cpu')
    step = kind.Call(cell.program_module().program(cfg, 'cpu'), inp, mix)
    prog = kind.sample(step, mix)
    ref = kind.reference(cell.reference_module(), cfg, inp, mix)
    for g, r in zip(prog['grads'], ref['grads']):
        assert torch.allclose(g, r, atol=1e-5 * float(r.abs().max()), rtol=1e-4)
    assert abs(prog['losses'][0] - ref['losses'][0]) <= 1e-6 * ref['losses'][0]
    numbers = kind.compare(prog, ref)
    assert numbers['grad'] < 1e-5 and numbers['image'] == 0.0
    assert numbers['change'] < 1e-3 and numbers['loss'] < 1e-3
