"""Standard RoI head, bbox branch (counterpart of
``arfe_tpu/models/roi_heads/standard_roi_head.py:20-124,146-217,264-341``):
proposals in as (B, P, 5) with a validity mask. Inference gives detections
with fixed capacity; training assigns and samples every image's candidates
into ``num`` fixed slots and returns the bbox losses.

With ``multi_rois`` (AR-RFF; on by default for a head with
``num_roi_groups == 3``) each RoI is extracted three times, as itself and
stretched by ``get_adaptive_scale_rois``, in one RoIAlign call over the 3R
RoIs, each on the level of its own box, and the three blocks are
concatenated channel-wise as [ori, lw, lh]. A head with ``with_multi_cls``
("+fac") also returns per-image presence logits, trained against the
classes of each image's sampled RoIs. OHEM and masks are not ported here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BBOX_ASSIGNERS, BBOX_SAMPLERS, HEADS, build_from_cfg
from ..builder import build_head, build_roi_extractor
from ..utils.additional import get_adaptive_scale_rois


def _rows(table, inds):
    """table (B, N, ...) at inds (B, S) -> (B, S, ...)."""
    return table[torch.arange(table.shape[0], device=table.device)[:, None],
                 inds]


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    def __init__(self, bbox_roi_extractor, bbox_head, multi_rois=None,
                 adaptive_scale_fac=1.0, train_cfg=None, test_cfg=None):
        super().__init__()
        self.bbox_roi_extractor = build_roi_extractor(bbox_roi_extractor)
        self.bbox_head = build_head(bbox_head)
        if multi_rois is None:
            multi_rois = getattr(self.bbox_head, 'num_roi_groups', 1) == 3
        self.multi_rois = multi_rois
        self.adaptive_scale_fac = adaptive_scale_fac
        self.with_multi_cls = getattr(self.bbox_head, 'with_multi_cls', False)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        if train_cfg is not None:
            self.assigner = build_from_cfg(train_cfg['assigner'],
                                           BBOX_ASSIGNERS)
            self.sampler = build_from_cfg(train_cfg['sampler'], BBOX_SAMPLERS)

    def _bbox_forward(self, feats, rois, num_imgs=1):
        """The head's outputs for (R, 5) RoIs of ``num_imgs`` images:
        (cls_score, bbox_pred), and multi_cls for a "+fac" head."""
        extractor = self.bbox_roi_extractor
        lvl_feats = feats[:extractor.num_inputs]
        if self.multi_rois:
            lh_rois, lw_rois = get_adaptive_scale_rois(
                rois, self.adaptive_scale_fac)
            all_feats = extractor(lvl_feats,
                                  torch.cat([rois, lw_rois, lh_rois]))
            bbox_feats = torch.cat(all_feats.chunk(3), dim=-1)
        else:
            bbox_feats = extractor(lvl_feats, rois)
        if self.with_multi_cls:
            return self.bbox_head(bbox_feats, num_imgs=num_imgs)
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
            dict of ``loss_cls``, ``acc`` and ``loss_bbox``, and
            ``loss_multi_cls`` for a "+fac" head.
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
        out = self._bbox_forward(feats, rois, num_imgs=b)
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(
                boxes, sampled['gt_boxes'], sampled['labels'],
                sampled['is_pos'], sampled['valid'],
                self.train_cfg.get('pos_weight', -1))
        loss_kw = {}
        if self.with_multi_cls:
            # each image's classes among its weighted slots, background too
            onehot = F.one_hot(labels, self.bbox_head.num_classes + 1)
            presence = (onehot * label_weights[..., None]).sum(dim=1) > 0
            loss_kw = dict(multi_cls=out[2], presence=presence.int())
        return self.bbox_head.loss(
            out[0], out[1], labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
            bbox_weights.reshape(-1, 4), **loss_kw)

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
        cls_score, bbox_pred = self._bbox_forward(feats, rois,
                                                  num_imgs=b)[:2]
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
