"""Cascade RoI head (counterpart of
``arfe_tpu/models/roi_heads/cascade_roi_head.py:22-226``): stages of
extraction and bbox head, each trained at its own IoU threshold with its own
assigner, sampler and box coder, each refining the boxes of the next.

Training: stage 0 takes the proposals (with their gradient into the RPN's
regression, as :class:`StandardRoIHead`), later stages the previous
stage's sampled boxes regressed by its head's detached predictions (the
boxes keep their gradient, as in the JAX package); the gts prepended
to a stage's candidates are not refined (``valid & ~is_gt``), and each
stage keeps its static slot count, so stage 0 sees G + P candidates and
later ones G + the previous stage's samples. The losses are ``s{i}.*``,
scaled by the stage's weight (``acc`` is not). Inference: every stage on
the boxes the previous one refined; the stages' raw class logits averaged
(mmdet 2.0's rule), decoded with the last stage's regression.

Cascade Mask R-CNN (``:37-47,60-67,145-176``): each stage also has a mask
head, ``mask_head.{i}``, trained on the leading ``num * pos_fraction`` slots
of that stage's samples (every positive: the sampler packs them first),
extracted with the stage's mask extractor (its bbox one where the config
gives none) against targets from the batch's gt crops
(``core.mask.mask_target_from_crops``); its ``s{i}.loss_mask`` is scaled by
the stage's weight. Serving gives boxes only, as the JAX package's
``simple_test`` (``:179-226``).

Parameter names: ``bbox_head.{i}.…`` and ``mask_head.{i}.…`` per stage.
"""
from __future__ import annotations

import torch
from torch import nn

from ...registry import BBOX_ASSIGNERS, BBOX_SAMPLERS, HEADS, build_from_cfg
from ..builder import build_head, build_roi_extractor
from .standard_roi_head import (assign_candidates, boxes_to_rois, mask_loss,
                                sample_candidates)


def _per_stage(cfg, num_stages):
    return list(cfg) if isinstance(cfg, (list, tuple)) \
        else [cfg] * num_stages


@HEADS.register_module()
class CascadeRoIHead(nn.Module):
    def __init__(self, num_stages, stage_loss_weights, bbox_roi_extractor=None,
                 bbox_head=None, mask_roi_extractor=None, mask_head=None,
                 shared_head=None, train_cfg=None, test_cfg=None):
        super().__init__()
        if shared_head is not None:
            raise NotImplementedError('CascadeRoIHead: shared_head is not '
                                      'ported')
        self.num_stages = num_stages
        self.stage_loss_weights = list(stage_loss_weights)
        self.bbox_roi_extractor = nn.ModuleList(
            build_roi_extractor(c)
            for c in _per_stage(bbox_roi_extractor, num_stages))
        self.bbox_head = nn.ModuleList(
            build_head(c) for c in _per_stage(bbox_head, num_stages))
        self.with_mask = mask_head is not None
        if self.with_mask:
            self.mask_roi_extractor = self.bbox_roi_extractor \
                if mask_roi_extractor is None else nn.ModuleList(
                    build_roi_extractor(c)
                    for c in _per_stage(mask_roi_extractor, num_stages))
            self.mask_head = nn.ModuleList(
                build_head(c) for c in _per_stage(mask_head, num_stages))
        self.with_multi_cls = False
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        if train_cfg is not None:
            self.stage_cfgs = _per_stage(train_cfg, num_stages)
            self.assigners = [build_from_cfg(c['assigner'], BBOX_ASSIGNERS)
                              for c in self.stage_cfgs]
            self.samplers = [build_from_cfg(c['sampler'], BBOX_SAMPLERS)
                             for c in self.stage_cfgs]

    @property
    def num_classes(self):
        return self.bbox_head[-1].num_classes

    @property
    def num_extractions(self):
        """RoIAlign calls in one request: one a stage."""
        return self.num_stages

    @property
    def num_step_extractions(self):
        """RoIAlign calls in one step, each with its gradient: one a stage,
        and one more a stage for the mask branch."""
        return self.num_stages * (1 + self.with_mask)

    @property
    def serves_masks(self):
        """A request gives boxes only (the JAX package's ``simple_test``)."""
        return False

    @property
    def stage_samplers(self):
        return self.samplers

    def classifiers(self):
        """The layers that give the class logits, one a stage."""
        return [head.fc_cls for head in self.bbox_head]

    def _bbox_forward(self, stage, feats, rois):
        extractor = self.bbox_roi_extractor[stage]
        return self.bbox_head[stage](extractor(feats[:extractor.num_inputs],
                                               rois))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def forward_train(self, feats, proposals, prop_valid, gt_bboxes,
                      gt_valid, gt_labels, gen, gt_mask_crops=None,
                      img_shapes=None):
        """Every stage's losses of a batch.

        Args:
            feats: per-level (B, C, H, W) features.
            proposals: (B, P, 5); prop_valid (B, P).
            gt_bboxes: (B, G, 4) padded; gt_valid (B, G); gt_labels (B, G).
            gen: the ``torch.Generator`` of the samplers' priorities.
            gt_mask_crops: (B, G, cs, cs) each gt's mask cut to its box;
                required with a mask head.
            img_shapes: (B, 2) (h, w) the refined boxes are clamped to.
        Returns:
            dict of ``s{i}.loss_cls``, ``s{i}.acc`` and ``s{i}.loss_bbox``,
            and ``s{i}.loss_mask`` with a mask head.
        """
        if self.with_mask and gt_mask_crops is None:
            raise ValueError('mask training needs gt_mask_crops in the '
                             'batch')
        losses = {}
        boxes, valid = proposals[..., :4], prop_valid
        for stage in range(self.num_stages):
            sampler = self.samplers[stage]
            cands, assigned, max_overlaps = assign_candidates(
                self.assigners[stage], sampler, boxes, valid, gt_bboxes,
                gt_valid)
            sampled = sample_candidates(sampler, gen, cands, assigned,
                                        max_overlaps, gt_bboxes, gt_labels)
            b, s = sampled['boxes'].shape[:2]
            # every slot is extracted, invalid ones too: their weight is 0
            rois = boxes_to_rois(sampled['boxes'])
            cls_score, bbox_pred = self._bbox_forward(stage, feats, rois)
            head = self.bbox_head[stage]
            labels, label_weights, bbox_targets, bbox_weights = \
                head.get_targets(sampled['boxes'], sampled['gt_boxes'],
                                 sampled['labels'], sampled['is_pos'],
                                 sampled['valid'],
                                 self.stage_cfgs[stage].get('pos_weight', -1))
            stage_losses = head.loss(
                cls_score, bbox_pred, labels.reshape(-1),
                label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
                bbox_weights.reshape(-1, 4))
            w = self.stage_loss_weights[stage]
            if self.with_mask:
                extractor = self.mask_roi_extractor[stage]
                stage_losses.update(mask_loss(
                    self.mask_head[stage], sampler, rois, sampled,
                    gt_mask_crops, lambda r, e=extractor: e(
                        feats[:e.num_inputs], r)))
            for name, value in stage_losses.items():
                losses[f's{stage}.{name}'] = value * w if 'loss' in name \
                    else value
            if stage < self.num_stages - 1:
                # the gts this stage prepended are not refined
                is_gt = sampled['inds'] < gt_bboxes.shape[1] \
                    if sampler.add_gt_as_proposals \
                    else torch.zeros_like(sampled['valid'])
                # the head's predictions detached; the boxes keep what
                # gradient they carry, as in the JAX package
                boxes = head.decoded_boxes_for_refine(
                    sampled['boxes'], cls_score.detach().reshape(b, s, -1),
                    bbox_pred.detach().reshape(b, s, -1), img_shapes)
                valid = sampled['valid'] & ~is_gt
        return losses

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale=False):
        """dets (B, max_per_img, 5), labels, valid from (B, P, 5) proposals
        and their (B, P) validity."""
        b, p = proposals.shape[:2]
        boxes = proposals[..., :4]
        logits = []
        for stage in range(self.num_stages):
            cls_score, bbox_pred = self._bbox_forward(stage, feats,
                                                      boxes_to_rois(boxes))
            cls_score = cls_score.reshape(b, p, -1)
            bbox_pred = bbox_pred.reshape(b, p, -1)
            logits.append(cls_score.float())
            if stage < self.num_stages - 1:
                boxes = self.bbox_head[stage].decoded_boxes_for_refine(
                    boxes, cls_score, bbox_pred, img_shapes)
        return self.bbox_head[-1].get_bboxes(
            boxes, sum(logits) / self.num_stages, bbox_pred, img_shapes,
            scale_factors, rescale=rescale, cfg=self.test_cfg,
            valid_mask=proposal_valid)
