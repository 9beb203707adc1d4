"""nerf_tiny on the system under test: the port's NeRF train step
(``jrender_tpu_torch.nerf.trainer.make_train_step``) at the sizes of
``nerf_tiny.json``, its nets and optimizer made by ``create_nerf``."""
from __future__ import annotations

from types import SimpleNamespace


class NerfProgram:
    def __init__(self, cfg: dict, device=None):
        from jrender_tpu_torch.nerf import trainer
        self.trainer, self.cfg, self.device = trainer, cfg, device

    def fresh(self, weight_seed: int):
        """(nets, optimizer, step): the coarse and fine nets with weights
        drawn from ``weight_seed``, their ``NerfOptimizer``, and the train
        step ``step(nets, image, pose, k, draws)``."""
        import torch
        c = self.cfg
        args = SimpleNamespace(**c['nerf'])
        rk, _, _, nets, opt = self.trainer.create_nerf(
            args, generator=torch.Generator().manual_seed(weight_seed), device=self.device)
        rk.pop('ndc', None)
        H = c['image_size']
        step = self.trainer.make_train_step(opt, rk, H, H, c['focal'], c['near'], c['far'],
                                            args.N_rand, 0, 0.5, False)
        return nets, opt, step

    def add_spans(self):
        """No spans of the benchmark's own: a traced run reads the
        program's."""


def program(cfg: dict, device=None) -> NerfProgram:
    return NerfProgram(cfg, device)
