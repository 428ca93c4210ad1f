"""AR-RFF bbox heads (counterpart of
``arfe_tpu/models/roi_heads/bbox_heads/multirois_bbox_head.py:21-74``).

The head takes 3C-channel RoI features, the original RoI's and its two
stretched versions' (``get_adaptive_scale_rois``) in the order [ori, lw, lh],
fuses them as ``final_conv(ori + ori * (wh_conv(lw) + hh_conv(lh)))`` and
runs the shared-FC cls / reg branches on the fused C channels.
"""
from __future__ import annotations

from ....layers import ConvModule
from ....registry import HEADS
from .bbox_head import ConvFCBBoxHead


@HEADS.register_module()
class MultiBBoxHead(ConvFCBBoxHead):
    #: C-channel RoI feature groups the head consumes: the RoI head extracts
    #: the three RoI sets when it finds 3
    num_roi_groups = 3

    def __init__(self, num_shared_convs=0, num_shared_fcs=2, num_ws_convs=2,
                 num_ws_fcs=2, **kwargs):
        self.num_ws_convs = num_ws_convs
        self.num_ws_fcs = num_ws_fcs
        super().__init__(num_shared_convs=num_shared_convs,
                         num_shared_fcs=num_shared_fcs, **kwargs)

    def _init_layers(self):
        c = self.in_channels
        for name in ('hh_conv', 'wh_conv', 'final_conv'):
            setattr(self, name, ConvModule(c, c, 3, padding=1,
                                           norm_cfg=self.norm_cfg,
                                           act_cfg='relu',
                                           weight_init='xavier'))
        super()._init_layers()

    def fuse(self, x):
        """(R, oh, ow, 3C) -> (R, oh, ow, C)."""
        c = self.in_channels
        ori, lw, lh = x.permute(0, 3, 1, 2).split(c, dim=1)
        fused = ori + ori * (self.wh_conv(lw) + self.hh_conv(lh))
        return self.final_conv(fused).permute(0, 2, 3, 1)

    def forward(self, x):
        return super().forward(self.fuse(x))


@HEADS.register_module()
class MultiRoIsBBoxHead(MultiBBoxHead):
    """The name the AR-RFF flagship's config uses."""
