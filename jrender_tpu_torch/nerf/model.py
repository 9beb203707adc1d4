"""The NeRF MLP and its positional encoding (plain PyTorch).

Counterpart of ``jrender_tpu/nerf/model.py``.  A network's weights are a
tree of the JAX package's layout (``{'pts_linears': [{'w', 'b'}, ...],
'feature_linear', 'alpha_linear', 'views_linears', 'rgb_linear'}`` or
``'output_linear'``, ``w`` as [in, out]); ``NeRF`` holds them as
parameters of an ``nn.Module`` and ``NeRF.tree()`` hands them to
``nerf_apply``.  Products are ``torch.matmul`` in float32; the package
never sets ``allow_tf32``, so TF32 enters no product on the card.

``compute_dtype=torch.bfloat16`` (``net_precision bf16``) rounds both
operands of every product to bfloat16 and multiplies them in float32: a
product of two bfloat16 values is exact in float32, and the sum stays in
float32, as the JAX package's ``preferred_element_type=float32`` keeps it
(``torch.matmul`` of two bfloat16 tensors would round its output).  The
gradients pass the same roundings backwards.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..vol.camera import linspace0


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return -10.0 * torch.log(x) / torch.log(torch.tensor(10.0, device=x.device))


def to8b(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


class Embedder:
    """Positional encoding: [x, sin(2^k x) for every k, cos(2^k x) for every k]."""

    def __init__(self, include_input=True, input_dims=3, max_freq_log2=9,
                 num_freqs=10, log_sampling=True, periodic_fns=(torch.sin, torch.cos)):
        self.include_input = include_input
        self.input_dims = input_dims
        self.periodic_fns = periodic_fns
        if log_sampling:
            self.freq_bands = 2.0 ** linspace0(max_freq_log2, num_freqs)
        else:
            self.freq_bands = torch.linspace(2.0 ** 0.0, 2.0 ** max_freq_log2, num_freqs)
        self.out_dim = (input_dims if include_input else 0) + \
            num_freqs * len(periodic_fns) * input_dims
        self._bands = {}

    def embed(self, inputs):
        bands = self._bands.get(inputs.device)
        if bands is None:
            bands = self._bands[inputs.device] = self.freq_bands.to(inputs.device)
        outs = [inputs] if self.include_input else []
        scaled = inputs[..., None, :] * bands[:, None]
        for fn in self.periodic_fns:
            outs.append(fn(scaled).reshape(inputs.shape[:-1] + (-1,)))
        return torch.cat(outs, -1)


def get_embedder(multires, i=0, input_dims=3):
    if i == -1:
        return (lambda x: x), input_dims
    eo = Embedder(include_input=True, input_dims=input_dims,
                  max_freq_log2=multires - 1, num_freqs=multires, log_sampling=True)
    return eo.embed, eo.out_dim


def _linear_init(fan_in, fan_out, generator):
    # torch nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return {'w': w, 'b': b}


def init_nerf_params(D=8, W=256, input_ch=3, input_ch_views=3, output_ch=4, skips=(4,),
                     use_viewdirs=False, generator=None):
    """A weight tree drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; None: torch's default), so a seed gives the same
    weights whichever device they go to."""
    params = {'pts_linears': []}
    in_dim = input_ch
    for i in range(D):
        params['pts_linears'].append(_linear_init(in_dim, W, generator))
        in_dim = W + input_ch if i in skips else W
    if use_viewdirs:
        params['feature_linear'] = _linear_init(W, W, generator)
        params['alpha_linear'] = _linear_init(W, 1, generator)
        params['views_linears'] = [_linear_init(input_ch_views + W, W // 2, generator)]
        params['rgb_linear'] = _linear_init(W // 2, 3, generator)
    else:
        params['output_linear'] = _linear_init(W, output_ch, generator)
    return params


def _dense(p, x, dtype=None):
    w, b = p['w'], p['b']
    if dtype is not None:
        w = w.to(dtype).float()
        x = x.to(dtype).float()
    return torch.matmul(x, w) + b


def nerf_apply(params, x, input_ch=3, input_ch_views=3, skips=(4,), use_viewdirs=False,
               compute_dtype=None):
    """Apply the NeRF MLP to x = [pts_embedded, views_embedded]."""
    input_pts = x[..., :input_ch]
    input_views = x[..., input_ch:input_ch + input_ch_views]
    h = input_pts
    for i, layer in enumerate(params['pts_linears']):
        h = torch.relu(_dense(layer, h, compute_dtype))
        if i in skips:
            h = torch.cat([input_pts, h], -1)
    if use_viewdirs:
        alpha = _dense(params['alpha_linear'], h, compute_dtype)
        feature = _dense(params['feature_linear'], h, compute_dtype)
        h = torch.cat([feature, input_views], -1)
        for layer in params['views_linears']:
            h = torch.relu(_dense(layer, h, compute_dtype))
        rgb = _dense(params['rgb_linear'], h, compute_dtype)
        return torch.cat([rgb, alpha], -1)
    return _dense(params['output_linear'], h, compute_dtype)


def _param(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().clone()
    return torch.tensor(np.array(x, np.float32))


class Dense(nn.Module):
    """One layer's weights, ``w`` [in, out] and ``b`` [out]."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(_param(w))
        self.b = nn.Parameter(_param(b).reshape(-1))

    def tree(self):
        return {'w': self.w, 'b': self.b}


_HEADS = ('feature_linear', 'alpha_linear', 'rgb_linear', 'output_linear')


class NeRF(nn.Module):
    """The NeRF MLP as an ``nn.Module``; ``params`` (a weight tree) sets its
    weights, else they are drawn from ``generator``."""

    def __init__(self, D=8, W=256, input_ch=3, input_ch_views=3, output_ch=4,
                 skips=(4,), use_viewdirs=False, generator=None, params=None, device=None):
        super().__init__()
        self.D = D
        self.W = W
        self.input_ch = input_ch
        self.input_ch_views = input_ch_views
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        if params is None:
            params = init_nerf_params(D, W, input_ch, input_ch_views, output_ch,
                                      self.skips, use_viewdirs, generator)
        self.pts_linears = nn.ModuleList([Dense(p['w'], p['b']) for p in params['pts_linears']])
        if use_viewdirs:
            self.views_linears = nn.ModuleList([Dense(p['w'], p['b'])
                                                for p in params['views_linears']])
        for k in _HEADS:
            if k in params:
                setattr(self, k, Dense(params[k]['w'], params[k]['b']))
        if device is not None:
            self.to(device)

    def tree(self):
        """The weights as the JAX package's tree (the parameters themselves)."""
        out = {'pts_linears': [l.tree() for l in self.pts_linears]}
        if self.use_viewdirs:
            out['views_linears'] = [l.tree() for l in self.views_linears]
        for k in _HEADS:
            if hasattr(self, k):
                out[k] = getattr(self, k).tree()
        return out

    def forward(self, x, compute_dtype=None):
        return nerf_apply(self.tree(), x, self.input_ch, self.input_ch_views, self.skips,
                          self.use_viewdirs, compute_dtype)

    def load_weights_from_keras(self, weights):
        """Import the official Keras weights: a flat list [w0, b0, w1, b1, ...]
        with each w as [in, out] (utils.py:118-145)."""
        assert self.use_viewdirs, 'Not implemented if use_viewdirs=False'
        dev = self.pts_linears[0].w.device

        def dense(i):
            return Dense(np.asarray(weights[i]), np.asarray(weights[i + 1])).to(dev)

        for i in range(self.D):
            self.pts_linears[i] = dense(2 * i)
        iD = 2 * self.D
        self.feature_linear = dense(iD)
        self.views_linears[0] = dense(iD + 2)
        self.rgb_linear = dense(iD + 4)
        self.alpha_linear = dense(iD + 6)
