"""Standard RoI head, bbox branch (counterpart of
``arfe_tpu/models/roi_heads/standard_roi_head.py:20-124,146-217,264-341``):
proposals in as (B, P, 5) with a validity mask. Inference gives detections
with fixed capacity; training assigns and samples every image's candidates
into ``num`` fixed slots and returns the bbox losses. The AR-RFF
``multi_rois`` extraction, OHEM and masks are not ported here.
"""
from __future__ import annotations

import torch
from torch import nn

from ...registry import BBOX_ASSIGNERS, BBOX_SAMPLERS, HEADS, build_from_cfg
from ..builder import build_head, build_roi_extractor


def _rows(table, inds):
    """table (B, N, ...) at inds (B, S) -> (B, S, ...)."""
    return table[torch.arange(table.shape[0], device=table.device)[:, None],
                 inds]


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    def __init__(self, bbox_roi_extractor, bbox_head, train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.bbox_roi_extractor = build_roi_extractor(bbox_roi_extractor)
        self.bbox_head = build_head(bbox_head)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        if train_cfg is not None:
            self.assigner = build_from_cfg(train_cfg['assigner'],
                                           BBOX_ASSIGNERS)
            self.sampler = build_from_cfg(train_cfg['sampler'], BBOX_SAMPLERS)

    def _bbox_forward(self, feats, rois):
        bbox_feats = self.bbox_roi_extractor(
            feats[:self.bbox_roi_extractor.num_inputs], rois)
        return self.bbox_head(bbox_feats)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _assign(self, proposals, prop_valid, gt_bboxes, gt_valid):
        """The candidates of each image, gts first when the sampler adds
        them (padded gts are invalid candidates), and their assignment:
        (boxes (B, N, 4), assigned_gt_inds (B, N), max_overlaps (B, N))."""
        if self.sampler.add_gt_as_proposals:
            boxes = torch.cat([gt_bboxes.float(), proposals[..., :4]], dim=1)
            box_valid = torch.cat([gt_valid, prop_valid], dim=1)
        else:
            boxes, box_valid = proposals[..., :4], prop_valid
        assign = self.assigner.assign(boxes, gt_bboxes, gt_valid,
                                      box_valid=box_valid)
        return boxes, assign['assigned_gt_inds'], assign['max_overlaps']

    def _sample(self, gen, boxes, assigned, max_overlaps, gt_bboxes,
                gt_labels):
        """Each image's candidates sampled into ``num`` slots, positives
        first: the slots' boxes, matched gt boxes and gt labels, and their
        is_pos / valid masks, all (B, num, ...)."""
        sample = self.sampler.sample(gen, assigned, max_overlaps=max_overlaps,
                                     num_gts=gt_bboxes.shape[1])
        inds = sample['inds']
        safe_gt = torch.clamp(_rows(assigned, inds) - 1, 0,
                              gt_bboxes.shape[1] - 1)
        return dict(boxes=_rows(boxes, inds),
                    gt_boxes=_rows(gt_bboxes.float(), safe_gt),
                    labels=_rows(gt_labels.long(), safe_gt),
                    is_pos=sample['is_pos'], valid=sample['valid'])

    def forward_train(self, feats, proposals, prop_valid, gt_bboxes,
                      gt_valid, gt_labels, gen):
        """Bbox losses of a batch.

        Args:
            feats: per-level (B, C, H, W) features.
            proposals: (B, P, 5); prop_valid (B, P).
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); gt_labels (B, G).
            gen: the ``torch.Generator`` of the sampler's priorities.
        Returns:
            dict of ``loss_cls``, ``acc`` and ``loss_bbox``.
        """
        boxes, assigned, max_overlaps = self._assign(proposals, prop_valid,
                                                     gt_bboxes, gt_valid)
        sampled = self._sample(gen, boxes, assigned, max_overlaps, gt_bboxes,
                               gt_labels)
        boxes = sampled['boxes']
        b, s = boxes.shape[:2]
        # every slot is extracted, invalid ones too: their loss weight is 0
        batch_inds = torch.arange(b, dtype=boxes.dtype,
                                  device=boxes.device)[:, None, None]
        rois = torch.cat([batch_inds.expand(b, s, 1), boxes],
                         dim=-1).reshape(b * s, 5)
        cls_score, bbox_pred = self._bbox_forward(feats, rois)
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(
                boxes, sampled['gt_boxes'], sampled['labels'],
                sampled['is_pos'], sampled['valid'],
                self.train_cfg.get('pos_weight', -1))
        return self.bbox_head.loss(
            cls_score, bbox_pred, labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
            bbox_weights.reshape(-1, 4))

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

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
