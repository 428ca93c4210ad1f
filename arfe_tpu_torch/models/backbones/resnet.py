"""ResNet backbone, pytorch style (counterpart of
``arfe_tpu/models/backbones/resnet.py``).

Parameter names follow torchvision / mmdet (``conv1``, ``bn1``,
``layer{1..4}.{i}``, ``downsample.0/1``). BatchNorm is always in frozen
(``norm_eval``) form: its statistics never change, its affine weight and bias
train. ``frozen_stages = k`` stops the gradient of the stem and of stages
1..k (``requires_grad`` off), as the JAX package's ``stop_gradient``
(``resnet.py:316-330``). ``norm_cfg`` and ``zero_init_residual`` are accepted
for the configs and unused. The TPU-only ``stem_space_to_depth`` key is
accepted and ignored: the plain 7x7 stem computes the same numbers.
"""
from __future__ import annotations

import torch
from torch import nn

from ...layers import BatchNorm, Conv2d, max_pool2d
from ...registry import BACKBONES


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            weight_init='kaiming_fan_out')
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            weight_init='kaiming_fan_out')
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes, 1, stride=stride, bias=False,
                   weight_init='kaiming_fan_out'),
            BatchNorm(planes)) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        # pytorch style: the stride sits on the 3x3 conv
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False,
                            weight_init='kaiming_fan_out')
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            weight_init='kaiming_fan_out')
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False,
                            weight_init='kaiming_fan_out')
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False,
                   weight_init='kaiming_fan_out'),
            BatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


@BACKBONES.register_module()
class ResNet(nn.Module):
    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth, in_channels=3, num_stages=4,
                 strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                 out_indices=(0, 1, 2, 3), style='pytorch', frozen_stages=-1,
                 norm_cfg=None, norm_eval=True, base_channels=64,
                 zero_init_residual=True, stem_space_to_depth=False):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet')
        if style != 'pytorch':
            raise NotImplementedError(f'ResNet style {style!r} is not ported')
        if not norm_eval:
            raise NotImplementedError('ResNet: only norm_eval=True is ported')
        block_cls, stage_blocks = self.arch_settings[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(in_channels, base_channels, 7, stride=2, padding=3,
                            bias=False, weight_init='kaiming_fan_out')
        self.bn1 = BatchNorm(base_channels)
        inplanes = base_channels
        self.num_stages = num_stages
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                need_ds = j == 0 and (stride != 1 or inplanes
                                      != planes * block_cls.expansion)
                blocks.append(block_cls(inplanes, planes, stride=stride,
                                        dilation=dilations[i],
                                        downsample=need_ds))
                inplanes = planes * block_cls.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
        self.frozen_stages = frozen_stages
        if frozen_stages >= 0:
            for m in [self.conv1, self.bn1] + [
                    getattr(self, f'layer{i}')
                    for i in range(1, frozen_stages + 1)]:
                m.requires_grad_(False)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
