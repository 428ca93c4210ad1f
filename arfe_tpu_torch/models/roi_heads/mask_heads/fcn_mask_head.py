"""FCN mask head (counterpart of
``arfe_tpu/models/roi_heads/mask_heads/fcn_mask_head.py:15-120``; ref:
mmdet/models/roi_heads/mask_heads/fcn_mask_head.py:20-250): ``num_convs``
3 x 3 ``ConvModule``s, a 2x transposed conv + ReLU, and a 1 x 1
``conv_logits`` with one mask per class. Parameter names are the
reference's: ``convs.{i}.conv``, ``upsample``, ``conv_logits``. NCHW
inside (channels_last on the card); RoI features in and logits out are
NHWC, as the JAX package's."""
from __future__ import annotations

import torch
from torch import nn

from ....layers import Conv2d, ConvModule, ConvTranspose2d
from ....registry import HEADS, LOSSES, build_from_cfg
from ...losses.cross_entropy_loss import binary_cross_entropy_with_logits


@HEADS.register_module()
class FCNMaskHead(nn.Module):
    def __init__(self, num_convs=4, roi_feat_size=14, in_channels=256,
                 conv_kernel_size=3, conv_out_channels=256, num_classes=80,
                 class_agnostic=False, upsample_cfg=None, conv_cfg=None,
                 norm_cfg=None, loss_mask=None):
        super().__init__()
        upsample = (upsample_cfg or {}).get('type', 'deconv')
        if upsample != 'deconv':
            raise NotImplementedError(f'FCNMaskHead: upsample {upsample!r} '
                                      'is not ported (the configs use '
                                      'deconv)')
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, conv_kernel_size,
                       padding=(conv_kernel_size - 1) // 2,
                       norm_cfg=norm_cfg, act_cfg='relu',
                       weight_init='kaiming_fan_out')
            for i in range(num_convs)])
        # with no convs the upsample reads the RoI features themselves
        self.upsample = ConvTranspose2d(
            conv_out_channels if num_convs else in_channels,
            conv_out_channels, 2, 2)
        self.conv_logits = Conv2d(conv_out_channels,
                                  1 if class_agnostic else num_classes, 1,
                                  weight_init='normal', init_std=0.001)
        self.loss_mask = build_from_cfg(
            loss_mask or dict(type='CrossEntropyLoss', use_mask=True,
                              loss_weight=1.0), LOSSES)

    def forward(self, x):
        """(R, 14, 14, C) RoI features -> (R, 28, 28, classes) logits."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = conv(x)
        x = torch.relu(self.upsample(x))
        return self.conv_logits(x).permute(0, 2, 3, 1)

    def loss(self, mask_pred, mask_targets, labels, pos_mask):
        """Per-RoI sigmoid cross entropy on the channel of its class (the
        only one with ``class_agnostic``), averaged over the mask's pixels,
        then over the positive RoIs (ref: fcn_mask_head.py:110-127).

        Args:
            mask_pred: (S, m, m, classes) logits of the sampled RoIs.
            mask_targets: (S, m, m) binary targets.
            labels: (S,) class of each RoI.
            pos_mask: (S,) bool, the RoIs that count (the positives).
        Returns:
            dict of ``loss_mask``.
        """
        if self.class_agnostic:
            sel = mask_pred[..., 0]
        else:
            safe = torch.clamp(labels.long(), 0, self.num_classes - 1)
            sel = torch.gather(mask_pred, -1, safe[:, None, None, None]
                               .expand(-1, *mask_pred.shape[1:3], 1))[..., 0]
        per_roi = binary_cross_entropy_with_logits(sel.float(),
                                                   mask_targets).mean((1, 2))
        w = pos_mask.to(per_roi.dtype)
        return dict(loss_mask=self.loss_mask.loss_weight
                    * (per_roi * w).sum() / torch.clamp(w.sum(), min=1.0))
