"""A ResNet stage run on every RoI's features, the shared head of the C4
detectors (counterpart of
``arfe_tpu/models/roi_heads/shared_heads/res_layer.py:17-50``).

Stage ``stage`` (default 3, ``layer4``) of a ResNet of ``depth``: at depth
50, (R, 14, 14, 1024) RoI features to (R, 7, 7, 2048). Parameters are named
``layer{stage + 1}.{j}.…``, under ``roi_head.shared_head.`` in a detector.
The extractor's (R, oh, ow, C) features are read as NCHW once (on the card a
channels_last view, no copy), run through the blocks, and returned as
(R, oh', ow', C'). BatchNorm is frozen (``norm_eval``) and ``norm_cfg`` is
not read, as in the backbone.
"""
from __future__ import annotations

from torch import nn

from ....registry import HEADS
from ...backbones.resnet import ResNet


@HEADS.register_module()
class ResLayer(nn.Module):
    def __init__(self, depth, stage=3, stride=2, dilation=1,
                 style='pytorch', norm_cfg=None, norm_eval=True,
                 with_cp=False, dcn=None, base_channels=64):
        super().__init__()
        if not norm_eval:
            raise NotImplementedError('ResLayer: only norm_eval=True is '
                                      'ported')
        if dcn is not None:
            raise NotImplementedError('ResLayer: dcn is not ported')
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'ResLayer style {style!r}: pytorch or caffe')
        block_cls, stage_blocks = ResNet.arch_settings[depth]
        self.stage = stage
        planes = base_channels * 2 ** stage
        inplanes = base_channels * 2 ** (stage - 1) * block_cls.expansion
        self.out_channels = planes * block_cls.expansion
        blocks = []
        for j in range(stage_blocks[stage]):
            s = stride if j == 0 else 1
            need_ds = j == 0 and (s != 1 or inplanes != self.out_channels)
            blocks.append(block_cls(inplanes, planes, stride=s,
                                    dilation=dilation, downsample=need_ds,
                                    style=style))
            inplanes = self.out_channels
        setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))

    def forward(self, x):
        """(R, oh, ow, C) RoI features -> (R, oh', ow', C')."""
        layer = getattr(self, f'layer{self.stage + 1}')
        return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
