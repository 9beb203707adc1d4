"""n3mr_sphere39k_1024 on the system under test: ``Renderer(dr_type=
'n3mr')`` at the sizes of ``n3mr_sphere39k_1024.json``.  ``render_mesh``
with no mode returns (rgb, depth, alpha)."""
from __future__ import annotations

from benchmark.harness.program import Program


class N3mrProgram(Program):
    backward_op = r'autograd::engine::evaluate_function: N3mrRasterizeCoreBackward.*'

    def outputs(self, out) -> dict:
        rgb, depth, alpha = out
        return {'rgb': rgb, 'alpha': alpha, 'depth': depth}


def program(cfg: dict, device=None) -> Program:
    return N3mrProgram(cfg, device)
