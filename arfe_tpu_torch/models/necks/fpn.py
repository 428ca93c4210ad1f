"""Feature Pyramid Network (counterpart of ``arfe_tpu/models/necks/fpn.py:
18-142``).

1x1 laterals over the inputs ``start_level`` to ``end_level``, nearest
top-down sum, 3x3 outputs; extra levels as stride-2 subsamples of the last
output (``max_pool2d(kernel 1, stride 2)``, the Faster R-CNN form) or, with
``add_extra_convs``, as stride-2 3x3 convs on the last input
(``'on_input'``, RetinaNet's), lateral or output, a ReLU before each
further one with ``relu_before_extra_convs``. Parameter names:
``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``; the extra convs
continue the ``fpn_convs`` index.
"""
from __future__ import annotations

import torch
from torch import nn

from ...layers import ConvModule, max_pool2d, resize_nearest
from ...registry import NECKS

EXTRA_SOURCES = ('on_input', 'on_lateral', 'on_output')


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels, out_channels, num_outs, start_level=0,
                 end_level=-1, add_extra_convs=False,
                 extra_convs_on_inputs=True, relu_before_extra_convs=False,
                 no_norm_on_lateral=False, conv_cfg=None, norm_cfg=None,
                 act_cfg=None, upsample_cfg=None):
        super().__init__()
        if norm_cfg is not None or act_cfg is not None or (
                upsample_cfg or {'mode': 'nearest'})['mode'] != 'nearest':
            raise NotImplementedError('FPN: norm_cfg, act_cfg and a '
                                      'non-nearest upsample are not ported')
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        if end_level == -1:
            self.backbone_end_level = self.num_ins
            if num_outs < self.num_ins - start_level:
                raise ValueError('FPN: num_outs < number of inputs used')
        else:
            self.backbone_end_level = end_level
            if end_level > self.num_ins or num_outs != end_level - start_level:
                raise ValueError('FPN: end_level must lie within the inputs '
                                 'and num_outs equal end_level - start_level')
        self.start_level = start_level
        if add_extra_convs is True:
            add_extra_convs = 'on_input' if extra_convs_on_inputs \
                else 'on_output'
        if add_extra_convs and add_extra_convs not in EXTRA_SOURCES:
            raise ValueError(f'FPN: add_extra_convs {add_extra_convs!r}')
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = range(start_level, self.backbone_end_level)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, act_cfg=None,
                       weight_init='xavier') for i in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1, act_cfg=None,
                       weight_init='xavier') for _ in used)
        if add_extra_convs:
            for i in range(num_outs - len(used)):
                c = in_channels[self.backbone_end_level - 1] \
                    if i == 0 and add_extra_convs == 'on_input' \
                    else out_channels
                self.fpn_convs.append(ConvModule(
                    c, out_channels, 3, stride=2, padding=1, act_cfg=None,
                    weight_init='xavier'))

    def forward(self, inputs):
        if len(inputs) != self.num_ins:
            raise ValueError(f'FPN: {len(inputs)} inputs, expected '
                             f'{self.num_ins}')
        laterals = [m(inputs[i + self.start_level])
                    for i, m in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[2:])
        used = len(laterals)
        outs = [self.fpn_convs[i](x) for i, x in enumerate(laterals)]
        if not self.add_extra_convs:
            while len(outs) < self.num_outs:
                outs.append(max_pool2d(outs[-1], 1, stride=2))
            return tuple(outs)
        if self.num_outs > used:
            source = {'on_input': inputs[self.backbone_end_level - 1],
                      'on_lateral': laterals[-1],
                      'on_output': outs[-1]}[self.add_extra_convs]
            outs.append(self.fpn_convs[used](source))
            for i in range(used + 1, self.num_outs):
                x = torch.relu(outs[-1]) if self.relu_before_extra_convs \
                    else outs[-1]
                outs.append(self.fpn_convs[i](x))
        return tuple(outs)
