"""The cross-RoI attention bbox head (counterpart of
``arfe_tpu/models/roi_heads/bbox_heads/multirois_variants.py:335-365``;
ref: attrois_bbox_head.py): each RoI's spatial signature (its features
reduced to one channel by a 1x1 conv + ReLU) attends over the signatures
of every RoI the head is given, of all the batch's images together and its
invalid slots too, as in the JAX package; the attended signature is added
to every channel before the shared-FC head. A request of two images is
therefore not two requests of one."""
from __future__ import annotations

import torch

from ....layers import ConvModule, Linear
from ....registry import HEADS
from .bbox_head import ConvFCBBoxHead


@HEADS.register_module()
class AttRoIsBBoxHead(ConvFCBBoxHead):
    num_roi_groups = 1

    def _init_layers(self):
        super()._init_layers()
        # the reference sizes this conv by conv_out_channels, which equals
        # the RoI features' channels in its configs
        self.channel_reduction = ConvModule(
            self.in_channels, 1, 1, act_cfg='relu', weight_init='xavier')
        self.fc1 = Linear(self.roi_feat_area, self.roi_feat_area)

    def forward(self, x):
        """x: (R, oh, ow, C) RoI features of the whole batch."""
        r, h, w, _ = x.shape
        rdt = self.channel_reduction(x.permute(0, 3, 1, 2)).reshape(r, -1)
        rtf = torch.softmax(self.fc1(rdt), -1)
        att = torch.softmax(rtf @ rdt.T, -1)                 # (R, R)
        return super().forward(x + (att @ rdt).reshape(r, h, w, 1))
