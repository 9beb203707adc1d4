"""softras_sphere39k_1024 on the system under test: ``Renderer(dr_type=
'softras')`` at the sizes of ``softras_sphere39k_1024.json``, on the
default route.  ``render_mesh`` with no mode returns (alpha, rgb)."""
from __future__ import annotations

from benchmark.harness.program import Program


class SoftRasProgram(Program):
    backward_op = r'autograd::engine::evaluate_function: SoftRasterizeBackward.*'

    def outputs(self, out) -> dict:
        alpha, rgb = out
        return {'rgb': rgb, 'alpha': alpha}


def program(cfg: dict, device=None) -> Program:
    return SoftRasProgram(cfg, device)
