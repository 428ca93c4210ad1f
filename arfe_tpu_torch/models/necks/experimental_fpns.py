"""ARFE's experimental necks (counterpart of
``arfe_tpu/models/necks/experimental_fpns.py:57-87,500-517,592-623,
745-792``; ref: mmdet/models/necks/{fpn_bu,fpn_cbam,fpn_relation}.py):
``FPNBU``, ``FPNCBAM`` with its ``CbamModule``, and ``FPNRelation``.

Each keeps the reference's quirks, as the JAX package does: FPNBU's
bottom-up 3x3 convs have no padding, so they shrink a map, which is then
resized to the next level by nearest neighbours; CBAM's spatial gate takes
a ReLU after its sigmoid. FPNRelation's relation map, a sum over an outer
product of two (h*w) maps, is computed as one map times the other's sum
over h*w, which is the same function without the h*w x h*w product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvModule, resize_nearest
from ...registry import NECKS
from .fpn import FPN


@NECKS.register_module()
class FPNBU(FPN):
    """FPN with a bottom-up pass over the laterals before the top-down one:
    each lateral but the last, through ``bu_convs[i]`` (3x3, no padding)
    and resized to the next lateral's size, is concatenated before that
    lateral and compressed back by ``compress_convs[i]`` (1x1)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        n = self.backbone_end_level - self.start_level
        c = self.out_channels
        self.bu_convs = nn.ModuleList(
            ConvModule(c, c, 3, act_cfg=None, weight_init='xavier')
            for _ in range(n - 1))
        self.compress_convs = nn.ModuleList(
            ConvModule(c * 2, c, 1, act_cfg=None, weight_init='xavier')
            for _ in range(n - 1))

    def _pre_topdown(self, laterals, inputs):
        for i in range(len(laterals) - 1):
            tmp = resize_nearest(self.bu_convs[i](laterals[i]),
                                 laterals[i + 1].shape[2:])
            laterals[i + 1] = self.compress_convs[i](
                torch.cat([tmp, laterals[i + 1]], 1))
        return laterals


class CbamModule(nn.Module):
    """CBAM's channel gate (a shared two-layer 1x1 MLP over the average-
    and max-pooled features, a sigmoid) then its spatial gate (a 3x3 conv +
    ReLU over the channel mean and max, a sigmoid, a ReLU). Parameter names:
    ``channel.fc1``, ``channel.fc2``, ``spatial.conv.conv``."""

    def __init__(self, channels, spatial_kernel_size=7, reduction=16):
        super().__init__()
        red = max(channels // reduction, 1)
        self.channel = nn.ModuleDict(dict(
            fc1=Conv2d(channels, red, 1, bias=False),
            fc2=Conv2d(red, channels, 1, bias=False)))
        self.spatial = nn.ModuleDict(dict(
            conv=ConvModule(2, 1, 3, padding=1, act_cfg='relu')))

    def forward(self, x):
        def mlp(v):
            return self.channel['fc2'](torch.relu(self.channel['fc1'](v)))

        attn = mlp(x.mean(dim=(2, 3), keepdim=True)) \
            + mlp(x.amax(dim=(2, 3), keepdim=True))
        x = x * torch.sigmoid(attn)
        sp = torch.cat([x.mean(dim=1, keepdim=True),
                        x.amax(dim=1, keepdim=True)], 1)
        return x * torch.relu(torch.sigmoid(self.spatial['conv'](sp)))


@NECKS.register_module()
class FPNCBAM(FPN):
    """CBAM on every lateral before the top-down pass."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cbam_convs = nn.ModuleList(
            CbamModule(self.out_channels)
            for _ in range(self.backbone_end_level - self.start_level))

    def _pre_topdown(self, laterals, inputs):
        return [m(x) for m, x in zip(self.cbam_convs, laterals)]


@NECKS.register_module()
class FPNRelation(nn.Module):
    """Adds an objectness and a classification relation map to every level
    (the second neck of a list, after an FPN). Both maps live at level 2's
    size: the objectness one from level 0 average-pooled to it through the
    1x1 ``com_convs``, the classification one from level 2 through the 3x3
    ``en_convs`` (each conv with its ReLU, then another ReLU, as in the
    reference)."""

    def __init__(self, in_channels, num_levels, conv_cfg=None,
                 norm_cfg=None):
        super().__init__()
        self.num_levels = num_levels
        self.en_convs = nn.ModuleList(
            ConvModule(in_channels, 1, 3, padding=1, act_cfg='relu',
                       weight_init='xavier') for _ in range(2))
        self.com_convs = nn.ModuleList(
            ConvModule(in_channels, 1, 1, act_cfg='relu',
                       weight_init='xavier') for _ in range(2))

    @staticmethod
    def _rel(m1, m2):
        """Each pixel of ``m1`` (B, 1, h, w) times the sum of ``m2`` over
        its h * w pixels, over h * w: the reference's row sums of the
        outer product of the two flattened maps."""
        h, w = m1.shape[2:]
        return m1 * m2.sum(dim=(2, 3), keepdim=True) / (h * w)

    def forward(self, inputs):
        if len(inputs) != self.num_levels:
            raise ValueError(f'FPNRelation: {len(inputs)} inputs, expected '
                             f'{self.num_levels}')
        size = inputs[2].shape[2:]
        inp = F.adaptive_avg_pool2d(inputs[0], size)
        obj = self._rel(*(torch.relu(m(inp)) for m in self.com_convs))
        cls = self._rel(*(torch.relu(m(inputs[2])) for m in self.en_convs))
        return tuple(x + resize_nearest(obj, x.shape[2:])
                     + resize_nearest(cls, x.shape[2:]) for x in inputs)
