"""AR-FPN refinement neck ``WFPNDualSpatial`` (counterpart of
``arfe_tpu/models/necks/wfpn.py:28-114``).

All levels are gathered to the ``refine_level`` resolution (adaptive max
pool down, nearest up) and averaged; a NonLocal2D block refines the average;
then per level ``out_i = in_i + resize(refined, size_i) * att_i`` with the
dual tanh map ``att_i = tanh(relu(conv_b(in_i))) + tanh(relu(conv_c(in_i)))``
of two 3x3 convs to one channel (``reduce_convs`` / ``reduce_convs2``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...layers import ConvModule, adaptive_max_pool2d, resize_nearest
from ...ops.non_local import NonLocal2D
from ...registry import NECKS


def _gather_levels(inputs, refine_level):
    """Resize every level to the refine level's resolution and average."""
    size = inputs[refine_level].shape[2:]
    acc = None
    for i, x in enumerate(inputs):
        x = adaptive_max_pool2d(x, size) if i < refine_level \
            else resize_nearest(x, size)
        acc = x if acc is None else acc + x
    return acc / len(inputs)


@NECKS.register_module()
class WFPNDualSpatial(nn.Module):
    def __init__(self, in_channels, num_levels, refine_level=2,
                 norm_cfg=None):
        super().__init__()
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.reduce_convs = nn.ModuleList(
            ConvModule(in_channels, 1, 3, padding=1, norm_cfg=norm_cfg,
                       act_cfg='relu', weight_init='xavier')
            for _ in range(num_levels))
        self.reduce_convs2 = nn.ModuleList(
            ConvModule(in_channels, 1, 3, padding=1, norm_cfg=norm_cfg,
                       act_cfg='relu', weight_init='xavier')
            for _ in range(num_levels))
        self.refine = NonLocal2D(in_channels, reduction=1, use_scale=False,
                                 norm_cfg=norm_cfg)

    def forward(self, inputs):
        if len(inputs) != self.num_levels:
            raise ValueError(f'WFPNDualSpatial: {len(inputs)} levels, '
                             f'expected {self.num_levels}')
        bsf = self.refine(_gather_levels(inputs, self.refine_level))
        outs = []
        for x, conv_b, conv_c in zip(inputs, self.reduce_convs,
                                     self.reduce_convs2):
            att = torch.tanh(conv_b(x)) + torch.tanh(conv_c(x))
            outs.append(x + resize_nearest(bsf, x.shape[2:]) * att)
        return tuple(outs)
