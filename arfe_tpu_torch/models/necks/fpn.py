"""Feature Pyramid Network (counterpart of ``arfe_tpu/models/necks/fpn.py``).

The Faster R-CNN form: 1x1 laterals, nearest top-down sum, 3x3 outputs, and
extra levels as stride-2 subsamples of the last output
(``max_pool2d(kernel 1, stride 2)``). Parameter names: ``lateral_convs.{i}
.conv``, ``fpn_convs.{i}.conv``.
"""
from __future__ import annotations

from torch import nn

from ...layers import ConvModule, max_pool2d, resize_nearest
from ...registry import NECKS


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels, out_channels, num_outs):
        super().__init__()
        if num_outs < len(in_channels):
            raise ValueError('FPN: num_outs < number of inputs')
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, act_cfg=None, weight_init='xavier')
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1, act_cfg=None,
                       weight_init='xavier')
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [m(x) for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)
