"""RetinaNet head (counterpart of
``arfe_tpu/models/dense_heads/retina_head.py:18-85``): per level, four
3x3 ``ConvModule``s + ReLU on each of the classification and regression
branches, then ``retina_cls`` (biased to the focal prior 0.01) and
``retina_reg``. Parameter names: ``cls_convs.{i}.conv``,
``reg_convs.{i}.conv``, ``retina_cls``, ``retina_reg``.
"""
from __future__ import annotations

import math

from torch import nn

from ...layers import Conv2d, ConvModule
from ...registry import HEADS
from .anchor_head import AnchorHead

#: the classifier's prior probability of an object (the bias -log(99))
PRIOR_PROB = 0.01


@HEADS.register_module()
class RetinaHead(AnchorHead):
    def __init__(self, num_classes, in_channels, stacked_convs=4,
                 conv_cfg=None, norm_cfg=None, anchor_generator=None,
                 **kwargs):
        self.stacked_convs = stacked_convs
        self.norm_cfg = norm_cfg
        super().__init__(num_classes, in_channels,
                         anchor_generator=anchor_generator or dict(
                             type='AnchorGenerator', octave_base_scale=4,
                             scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                             strides=[8, 16, 32, 64, 128]),
                         **kwargs)

    def _init_layers(self):
        def tower():
            return nn.ModuleList(
                ConvModule(self.in_channels if i == 0 else self.feat_channels,
                           self.feat_channels, 3, padding=1,
                           norm_cfg=self.norm_cfg, act_cfg='relu',
                           weight_init='normal', init_std=0.01)
                for i in range(self.stacked_convs))
        self.cls_convs = tower()
        self.reg_convs = tower()
        self.retina_cls = Conv2d(
            self.feat_channels, self.num_anchors * self.cls_out_channels, 3,
            padding=1, weight_init='normal', init_std=0.01,
            bias_value=-math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        self.retina_reg = Conv2d(self.feat_channels, self.num_anchors * 4, 3,
                                 padding=1, weight_init='normal',
                                 init_std=0.01)

    def classifiers(self):
        """The layers that give the class logits."""
        return [self.retina_cls]

    def forward_single(self, x):
        cls_feat = reg_feat = x
        for m in self.cls_convs:
            cls_feat = m(cls_feat)
        for m in self.reg_convs:
            reg_feat = m(reg_feat)
        return self.retina_cls(cls_feat), self.retina_reg(reg_feat)
