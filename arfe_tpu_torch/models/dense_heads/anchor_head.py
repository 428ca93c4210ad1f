"""Anchor-based dense head base, inference parts (counterpart of
``arfe_tpu/models/dense_heads/anchor_head.py:38-84``): box coder, anchor
generator and classification channels from the config. The ``loss_*`` and
``train_cfg`` entries are accepted for the configs; inference reads only
``loss_cls.use_sigmoid``."""
from __future__ import annotations

from torch import nn

from ...registry import ANCHOR_GENERATORS, BBOX_CODERS, build_from_cfg


class AnchorHead(nn.Module):
    def __init__(self, num_classes, in_channels, feat_channels=256,
                 anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        loss_cls = loss_cls or dict(type='CrossEntropyLoss', use_sigmoid=True)
        self.use_sigmoid_cls = loss_cls.get('use_sigmoid', False)
        self.cls_out_channels = (num_classes if self.use_sigmoid_cls
                                 else num_classes + 1)
        self.bbox_coder = build_from_cfg(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder'), BBOX_CODERS)
        self.anchor_generator = build_from_cfg(
            anchor_generator or dict(type='AnchorGenerator',
                                     scales=[8, 16, 32],
                                     ratios=[0.5, 1.0, 2.0],
                                     strides=[4, 8, 16, 32, 64]),
            ANCHOR_GENERATORS)
        self.num_anchors = self.anchor_generator.num_base_anchors[0]
        self.test_cfg = test_cfg
        self._init_layers()

    def _init_layers(self):
        raise NotImplementedError
