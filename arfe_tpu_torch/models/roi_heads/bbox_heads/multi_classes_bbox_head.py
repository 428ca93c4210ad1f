"""The "+fac" bbox head (counterpart of
``arfe_tpu/models/roi_heads/bbox_heads/multi_classes_bbox_head.py:24-106``).

A ConvFC bbox head on attention-refined RoI features that also predicts
which classes an image holds: channel attention, then a one-channel spatial
attention (``spa_conv``) give ``mean_mat``; ``refine_conv`` feeds the cls /
reg branches, and each image's mean of ``mean_mat`` over all its RoI slots
(invalid ones too), flattened in (C, H, W) order, goes through ``pre_fc``
and ``multi_cls_reg`` to (C + 1, 2) presence logits. Its loss adds
``loss_multi_cls``, the per-image presence hinge averaged over the images.
"""
from __future__ import annotations

import torch

from ....layers import ConvModule, Linear
from ....registry import HEADS, LOSSES, build_from_cfg
from .bbox_head import ConvFCBBoxHead


@HEADS.register_module()
class MultiClassesBBoxHead(ConvFCBBoxHead):
    with_multi_cls = True

    def __init__(self, loss_multi_cls=None, **kwargs):
        super().__init__(**kwargs)
        self.loss_multi_cls = build_from_cfg(loss_multi_cls or dict(
            type='CrossEntropyLoss', use_multi_cls=True, loss_weight=1.0),
            LOSSES)

    def _init_layers(self):
        c = self.in_channels
        self.spa_conv = ConvModule(c, 1, 3, padding=1, norm_cfg=self.norm_cfg,
                                   act_cfg='relu', weight_init='xavier')
        self.refine_conv = ConvModule(c, c, 1, norm_cfg=self.norm_cfg,
                                      act_cfg='relu', weight_init='xavier')
        self.pre_fc = Linear(self.roi_feat_area * c, 256,
                             weight_init='xavier')
        self.multi_cls_reg = Linear(256, (self.num_classes + 1) * 2,
                                    weight_init='xavier')
        super()._init_layers()

    def forward(self, x, num_imgs=1):
        """x: (R, oh, ow, C), R a multiple of ``num_imgs``. Returns
        cls_score (R, C + 1), bbox_pred (R, 4k) and multi_cls
        (num_imgs, C + 1, 2)."""
        x = x.permute(0, 3, 1, 2)
        x_mc = x + x * torch.relu(x.mean(dim=(2, 3), keepdim=True))
        mean_mat = x + x * self.spa_conv(x_mc)
        final_feat = self.refine_conv(mean_mat).permute(0, 2, 3, 1)
        cls_score, bbox_pred = super().forward(final_feat)
        r = mean_mat.shape[0]
        per_img = mean_mat.reshape((num_imgs, r // num_imgs)
                                   + mean_mat.shape[1:]).mean(dim=1)
        fc1 = torch.relu(self.pre_fc(per_img.reshape(num_imgs, -1)))
        multi_cls = self.multi_cls_reg(fc1).reshape(num_imgs,
                                                    self.num_classes + 1, 2)
        return cls_score, bbox_pred, multi_cls

    def loss(self, cls_score, bbox_pred, labels, label_weights, bbox_targets,
             bbox_weights, multi_cls=None, presence=None):
        """The bbox losses, and ``loss_multi_cls`` where ``multi_cls`` and
        ``presence`` ((num_imgs, C + 1) multi-hot of the classes among each
        image's sampled RoIs, background included) are given."""
        losses = super().loss(cls_score, bbox_pred, labels, label_weights,
                              bbox_targets, bbox_weights)
        if multi_cls is not None and presence is not None:
            losses['loss_multi_cls'] = self.loss_multi_cls(
                multi_cls.float(), presence).mean()
        return losses


@HEADS.register_module()
class Shared2FCMultiClassesBBoxHead(MultiClassesBBoxHead):
    def __init__(self, fc_out_channels=1024, **kwargs):
        super().__init__(num_shared_convs=0, num_shared_fcs=2,
                         num_cls_convs=0, num_cls_fcs=0, num_reg_convs=0,
                         num_reg_fcs=0, fc_out_channels=fc_out_channels,
                         **kwargs)
