"""Building blocks of the port (counterpart of ``arfe_tpu/layers.py``).

Modules are ``nn.Module``s whose parameter names equal the JAX package's
parameter paths (``conv.weight``, ``bn.running_mean``, ...), so a converted
JAX parameter tree loads with ``load_state_dict(strict=True)``. Tensors are
NCHW and, on the card, in ``torch.channels_last`` memory format. Weights are
kept in f32 and cast to the activation dtype at use, as the JAX modules do, so
one model serves f32 and bf16 requests.

Random initialisation mirrors the JAX initialisers and draws from an
explicit ``torch.Generator`` (:func:`init_weights`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def _uniform(t, bound, gen):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def _normal(t, std, gen):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


class Conv2d(nn.Module):
    """Conv with an OIHW ``weight`` and optional ``bias``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True,
                 weight_init='torch_default', init_std=0.01, bias_value=0.0):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.weight_init = weight_init
        self.init_std = init_std
        self.bias_value = bias_value
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset(self, gen):
        o, i, kh, kw = self.weight.shape
        fan_in, fan_out = i * kh * kw, o * kh * kw
        if self.weight_init == 'normal':
            _normal(self.weight, self.init_std, gen)
        elif self.weight_init == 'xavier':
            _uniform(self.weight, math.sqrt(6.0 / (fan_in + fan_out)), gen)
        elif self.weight_init == 'kaiming_fan_out':
            _normal(self.weight, math.sqrt(2.0 / fan_out), gen)
        else:  # torch default: kaiming_uniform(a=sqrt(5))
            _uniform(self.weight, math.sqrt(1.0 / fan_in), gen)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_value)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.Module):
    """Transposed conv with an IOHW ``weight`` (torch's layout; the JAX
    package stores the spatially flipped HWIO kernel of the equivalent
    convolution, ``convert.jax2torch`` turns one into the other) and a
    ``bias``, initialised as the JAX module: uniform within sqrt(1 /
    (in_channels * k * k)), bias 0."""

    def __init__(self, in_channels, out_channels, kernel_size=2, stride=2):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset(self, gen):
        i, _, kh, kw = self.weight.shape
        _uniform(self.weight, math.sqrt(1.0 / (i * kh * kw)), gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride)


class Linear(nn.Module):
    """Dense layer with an (out, in) ``weight``."""

    def __init__(self, in_features, out_features, bias=True,
                 weight_init='torch_default', init_std=0.01):
        super().__init__()
        self.weight_init = weight_init
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset(self, gen):
        if self.weight_init == 'normal':
            _normal(self.weight, self.init_std, gen)
        else:
            _uniform(self.weight, math.sqrt(1.0 / self.weight.shape[1]), gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
    """BatchNorm with frozen running statistics (``norm_eval=True``): an
    affine map ``x * scale + offset`` computed in f32, applied in x's dtype."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer('running_mean', torch.empty(num_features))
        self.register_buffer('running_var', torch.empty(num_features))

    def reset(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        offset = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) \
            + offset.to(x.dtype).view(shape)


def build_norm(norm_cfg, num_channels):
    """BN (and SyncBN) -> :class:`BatchNorm`; None -> None."""
    if norm_cfg is None:
        return None
    cfg = dict(norm_cfg)
    t = cfg.pop('type')
    cfg.pop('requires_grad', None)
    if t in ('BN', 'SyncBN'):
        return BatchNorm(num_channels, **cfg)
    raise KeyError(f'Unsupported norm type {t}')


_ACTS = {None: None, 'relu': torch.relu, 'sigmoid': torch.sigmoid,
         'tanh': torch.tanh}


class ConvModule(nn.Module):
    """conv (+ norm) (+ activation); children ``conv`` and ``bn``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, norm_cfg=None,
                 act_cfg='relu', bias='auto', weight_init='torch_default',
                 init_std=0.01, bias_value=0.0):
        super().__init__()
        if bias == 'auto':
            bias = norm_cfg is None
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, groups, bias,
                           weight_init=weight_init, init_std=init_std,
                           bias_value=bias_value)
        self.bn = build_norm(norm_cfg, out_channels)
        if act_cfg not in _ACTS:
            raise KeyError(f'Unsupported act {act_cfg}')
        self.act = _ACTS[act_cfg]

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return y if self.act is None else self.act(y)


def init_weights(module, gen):
    """Randomly initialise every layer of ``module`` from ``gen``, then let
    composite modules adjust (e.g. NonLocal2D zeroes its output conv)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, BatchNorm)):
            m.reset(gen)
    for m in module.modules():
        if hasattr(m, 'after_init'):
            m.after_init()


# ---------------------------------------------------------------------------
# functional ops (NCHW)
# ---------------------------------------------------------------------------

def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Max pool padded with -inf; a kernel-1 pool is a strided slice."""
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride if stride is not None else kernel_size)
    ph, pw = _pair(padding)
    if kh == kw == 1 and ph == pw == 0:
        return x[:, :, ::sh, ::sw]
    return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))


def adaptive_max_pool2d(x, output_size):
    """Adaptive max pool: cell i takes rows [floor(i*h/oh), ceil((i+1)*h/oh)),
    computed with integer arithmetic on the host."""
    oh, ow = _pair(output_size)

    def pool_axis(arr, out, dim):
        size = arr.shape[dim]
        starts = (np.arange(out) * size) // out
        ends = -(-(np.arange(out) + 1) * size // out)
        kmax = int((ends - starts).max())
        idx = starts[:, None] + np.arange(kmax)[None, :]
        mask = idx < ends[:, None]
        idx = np.minimum(idx, size - 1)
        g = torch.index_select(arr, dim, torch.from_numpy(
            idx.reshape(-1)).to(arr.device))
        g = g.reshape(arr.shape[:dim] + (out, kmax) + arr.shape[dim + 1:])
        m = torch.from_numpy(mask).to(arr.device).reshape(
            (1,) * dim + (out, kmax) + (1,) * (arr.dim() - dim - 1))
        return torch.where(m, g, float('-inf')).amax(dim=dim + 1)

    return pool_axis(pool_axis(x, oh, 2), ow, 3)


def resize_nearest(x, size):
    """Nearest resize to (h, w): source index ``(dst_index * src) // dst``,
    in integers (``F.interpolate``'s float scale is not relied on)."""
    for dim, dst in ((2, size[0]), (3, size[1])):
        src = x.shape[dim]
        if dst != src:
            idx = torch.arange(dst, device=x.device) * src // dst
            x = torch.index_select(x, dim, idx)
    return x
