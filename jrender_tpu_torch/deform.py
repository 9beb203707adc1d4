"""Demo 2's optimisation step: deform a template to match silhouettes.

Counterpart of the step in ``demos/demo2-deform.py`` (:49-80), which the
JAX package jits as one function: the ``build_vertices`` parameterisation,
the render of a batch of views, and the loss ``neg_iou + 0.03 * laplacian
+ 0.0003 * flatten``.  Here it is an ``nn.Module`` whose parameters are
demo 2's ``displace`` and ``center``; the caller owns the optimizer
(``torch.optim.Adam(lr=0.01, betas=(0.5, 0.99))`` in the demo).
"""
from __future__ import annotations

import torch
from torch import nn

from .loss import FlattenLoss, LaplacianLoss, neg_iou_loss
from .structures import Mesh


def build_vertices(vertices0, displace, center):
    """Vertices [1,V,3] inside the unit cube from the template
    ``vertices0`` (strictly inside it), a per-vertex ``displace`` in logit
    space and a ``center`` [1,1,3] (demo2-deform.py:61-66)."""
    base = torch.log(vertices0.abs() / (1 - vertices0.abs()))
    centroid = torch.tanh(center)
    v = torch.sigmoid(base + displace) * torch.sign(vertices0)
    v = torch.relu(v) * (1 - centroid) - torch.relu(-v) * (centroid + 1)
    return v + centroid


class DeformModel(nn.Module):
    """The template, its parameters and the regularisers of demo 2; built
    on the CPU, moved to the card with ``.to('cuda')``."""

    def __init__(self, vertices0, faces):
        super().__init__()
        vertices0 = torch.as_tensor(vertices0, dtype=torch.float32)
        if vertices0.dim() == 2:
            vertices0 = vertices0[None]
        faces = torch.as_tensor(faces).long()
        if faces.dim() == 2:
            faces = faces[None]
        self.register_buffer('vertices0', vertices0)
        self.register_buffer('faces', faces)
        self.displace = nn.Parameter(torch.zeros_like(vertices0))
        self.center = nn.Parameter(torch.zeros((1, 1, 3)))
        self.laplacian_loss = LaplacianLoss(vertices0[0].numpy(), faces[0].numpy())
        self.flatten_loss = FlattenLoss(faces[0].numpy())

    def vertices(self):
        return build_vertices(self.vertices0, self.displace, self.center)

    def loss(self, renderer, targets):
        """(loss, silhouettes [B,H,W]) against ``targets`` [B,H,W]; the
        renderer's camera holds one eye per view."""
        B = targets.shape[0]
        v = self.vertices()
        mesh = Mesh(v.expand(B, -1, -1), self.faces.expand(B, -1, -1), device=v.device)
        sil = renderer.render_mesh(mesh, mode='silhouettes')
        loss = neg_iou_loss(sil, targets) + 0.03 * self.laplacian_loss(v).mean() \
            + 0.0003 * self.flatten_loss(v).mean()
        return loss, sil


def deform_step(model: DeformModel, optimizer, renderer, targets):
    """One optimisation step; returns (loss, silhouettes), both detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, sil = model.loss(renderer, targets)
    loss.backward()
    optimizer.step()
    return loss.detach(), sil.detach()
