"""NonLocal2D embedded-gaussian block, the AR-FPN refine (counterpart of
``arfe_tpu/ops/non_local.py``).

Three 1x1 projections ``g`` / ``theta`` / ``phi`` (kept as separate modules so
the parameter names match), attention over the H*W positions through
:func:`fused_softmax_attention` (the CUDA kernel on the card), and a residual
1x1 ``conv_out``, zero-initialised so the block starts as the identity.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import ConvModule
from .fused_attention import fused_softmax_attention


class NonLocal2D(nn.Module):
    def __init__(self, in_channels, reduction=2, use_scale=True,
                 norm_cfg=None, mode='embedded_gaussian'):
        super().__init__()
        if mode != 'embedded_gaussian':
            raise NotImplementedError(f'NonLocal2D mode {mode!r} is not '
                                      'ported')
        self.inter_channels = in_channels // reduction
        self.use_scale = use_scale
        ic = self.inter_channels
        self.g = ConvModule(in_channels, ic, 1, act_cfg=None,
                            weight_init='normal', init_std=0.01)
        self.theta = ConvModule(in_channels, ic, 1, act_cfg=None,
                                weight_init='normal', init_std=0.01)
        self.phi = ConvModule(in_channels, ic, 1, act_cfg=None,
                              weight_init='normal', init_std=0.01)
        self.conv_out = ConvModule(ic, in_channels, 1, norm_cfg=norm_cfg,
                                   act_cfg=None, weight_init='normal',
                                   init_std=0.01)

    def after_init(self):
        with torch.no_grad():
            self.conv_out.conv.weight.zero_()
            if self.conv_out.conv.bias is not None:
                self.conv_out.conv.bias.zero_()

    def forward(self, x):
        n, _, h, w = x.shape
        ic = self.inter_channels

        def tokens(m):   # (N, ic, H, W) -> contiguous (N, H*W, ic)
            return m(x).permute(0, 2, 3, 1).reshape(n, h * w, ic).contiguous()

        scale = 1.0 / float(ic) ** 0.5 if self.use_scale else None
        y = fused_softmax_attention(tokens(self.theta), tokens(self.phi),
                                    tokens(self.g), scale)
        y = y.reshape(n, h, w, ic).permute(0, 3, 1, 2).to(x.dtype)
        return x + self.conv_out(y)
