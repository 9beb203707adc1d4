"""Mesh regularization losses (counterpart of ``jrender_tpu/loss/losses.py``).

Parity targets in the reference:
  * LaplacianLoss -- jrender/loss/laplacian_loss.py:6-36
  * FlattenLoss   -- jrender/loss/flatten_loss.py:5-81
  * neg_iou_loss  -- jrender/loss/iou_loss.py:1-4

The graph preprocessing runs once in ``__init__`` on the host with numpy,
as in the JAX package (its own copy here); the per-step math is plain
PyTorch.  The two losses are ``nn.Module``s whose graph data are
registered buffers, so ``.to(device)`` moves them with the model.  The
Laplacian is applied as a dense matrix product.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def laplacian_matrix(num_vertices: int, faces) -> np.ndarray:
    """Row-normalised graph Laplacian [V,V] of a triangle mesh."""
    faces = np.asarray(faces).astype(np.int32)
    laplacian = np.zeros([num_vertices, num_vertices], dtype=np.float32)
    laplacian[faces[:, 0], faces[:, 1]] = -1
    laplacian[faces[:, 1], faces[:, 0]] = -1
    laplacian[faces[:, 1], faces[:, 2]] = -1
    laplacian[faces[:, 2], faces[:, 1]] = -1
    laplacian[faces[:, 2], faces[:, 0]] = -1
    laplacian[faces[:, 0], faces[:, 2]] = -1
    r, c = np.diag_indices(laplacian.shape[0])
    laplacian[r, c] = -laplacian.sum(1)
    for i in range(num_vertices):
        laplacian[i, :] /= laplacian[i, i]
    return laplacian


def flatten_edges(faces) -> np.ndarray:
    """[4, E] vertex ids (v0, v1, v2, v3) of every edge (v0, v1) with two
    adjacent faces and their opposite vertices v2 and v3; the edges are
    those the reference iterates (from f[:, 0:2] and f[:, 1:3])."""
    faces = np.asarray(faces).astype(np.int32)
    edge_opposites = {}
    for f in faces:
        for k in range(3):
            a, b, c = f[k], f[(k + 1) % 3], f[(k + 2) % 3]
            edge_opposites.setdefault((min(a, b), max(a, b)), []).append(int(c))
    seen = sorted(set(
        tuple(e) for e in np.sort(np.concatenate([faces[:, 0:2], faces[:, 1:3]], axis=0), axis=1)))
    quads = []
    for a, b in seen:
        opp = edge_opposites.get((int(min(a, b)), int(max(a, b))), [])
        if len(opp) >= 2:
            quads.append((int(a), int(b), opp[0], opp[1]))
    return np.asarray(quads, np.int64).reshape(-1, 4).T


class LaplacianLoss(nn.Module):
    def __init__(self, vertex, faces, average: bool = False):
        super().__init__()
        vertex = np.asarray(vertex)
        self.nv = vertex.shape[0]
        self.nf = np.asarray(faces).shape[0]
        self.average = average
        self.register_buffer('laplacian',
                             torch.from_numpy(laplacian_matrix(self.nv, faces)))

    def forward(self, x):
        batch_size = x.shape[0]
        x = torch.matmul(self.laplacian, x)
        x = (x ** 2).sum(dim=tuple(range(1, x.dim())))
        if self.average:
            return x.sum() / batch_size
        return x


class FlattenLoss(nn.Module):
    """Penalize dihedral angles of interior edges: sum (cos + 1)^2."""

    def __init__(self, faces, average: bool = False):
        super().__init__()
        self.nf = np.asarray(faces).shape[0]
        self.average = average
        quads = torch.from_numpy(flatten_edges(faces))
        for name, ids in zip(('v0s', 'v1s', 'v2s', 'v3s'), quads):
            self.register_buffer(name, ids.clone())

    def forward(self, vertices, eps: float = 1e-6):
        batch_size = vertices.shape[0]
        v0s = vertices[:, self.v0s, :]
        v1s = vertices[:, self.v1s, :]
        v2s = vertices[:, self.v2s, :]
        v3s = vertices[:, self.v3s, :]

        def foot(a, b):
            """b minus its projection on a, and that vector's length as the
            reference computes it (|b| sin)."""
            al2 = (a ** 2).sum(-1)
            bl2 = (b ** 2).sum(-1)
            al1 = torch.sqrt(al2 + eps)
            bl1 = torch.sqrt(bl2 + eps)
            ab = (a * b).sum(-1)
            cos = ab / (al1 * bl1 + eps)
            sin = torch.sqrt(1 - cos ** 2 + eps)
            c = a * (ab / (al2 + eps))[..., None]
            return b - c, bl1 * sin

        cb1, cb1l1 = foot(v1s - v0s, v2s - v0s)
        cb2, cb2l1 = foot(v1s - v0s, v3s - v0s)
        cos = (cb1 * cb2).sum(-1) / (cb1l1 * cb2l1 + eps)
        loss = ((cos + 1) ** 2).sum(dim=tuple(range(1, cos.dim())))
        if self.average:
            return loss.sum() / batch_size
        return loss


def neg_iou_loss(predict, target):
    dims = tuple(range(1, predict.dim()))
    intersect = (predict * target).sum(dim=dims)
    union = (predict + target - predict * target).sum(dim=dims) + 1e-6
    return 1.0 - (intersect / union).sum() / intersect.numel()
