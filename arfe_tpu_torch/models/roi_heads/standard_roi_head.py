"""Standard RoI head, bbox inference (counterpart of
``arfe_tpu/models/roi_heads/standard_roi_head.py:264-341``): proposals in as
(B, P, 5) with a validity mask, detections out with fixed capacity. The
AR-RFF ``multi_rois`` extraction, masks and training are not ported here.
"""
from __future__ import annotations

import torch
from torch import nn

from ...registry import HEADS
from ..builder import build_head, build_roi_extractor


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    def __init__(self, bbox_roi_extractor, bbox_head, train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.bbox_roi_extractor = build_roi_extractor(bbox_roi_extractor)
        self.bbox_head = build_head(bbox_head)
        self.test_cfg = test_cfg

    def _bbox_forward(self, feats, rois):
        bbox_feats = self.bbox_roi_extractor(
            feats[:self.bbox_roi_extractor.num_inputs], rois)
        return self.bbox_head(bbox_feats)

    def simple_test_bboxes(self, feats, proposals, proposal_valid,
                           img_shapes, scale_factors, rescale=False,
                           cfg=None):
        """dets (B, max_per_img, 5), labels, valid from (B, P, 5) proposals
        and their (B, P) validity."""
        cfg = self.test_cfg if cfg is None else cfg
        b, p, _ = proposals.shape
        batch_inds = torch.arange(b, dtype=proposals.dtype,
                                  device=proposals.device)[:, None, None]
        rois = torch.cat([batch_inds.expand(b, p, 1), proposals[..., :4]],
                         dim=-1).reshape(b * p, 5)
        cls_score, bbox_pred = self._bbox_forward(feats, rois)
        cls_score = cls_score.reshape(b, p, -1)
        if bbox_pred is not None:
            bbox_pred = bbox_pred.reshape(b, p, -1)
        return self.bbox_head.get_bboxes(
            proposals[..., :4], cls_score, bbox_pred, img_shapes,
            scale_factors, rescale=rescale, cfg=cfg,
            valid_mask=proposal_valid)

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale=False):
        return self.simple_test_bboxes(feats, proposals, proposal_valid,
                                       img_shapes, scale_factors,
                                       rescale=rescale)
