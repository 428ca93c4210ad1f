"""Assigners over padded boxes (counterpart of
``arfe_tpu/core/bbox/assigners.py:20-121,145-233``): ``MaxIoUAssigner``,
and FSAF's ``CenterRegionAssigner``.

Batched: ground truth comes as (B, G, 4) with a (B, G) ``gt_valid`` mask,
the boxes as (N, 4) shared by the images or (B, N, 4), with an optional
(B, N) ``box_valid``. The result ``assigned_gt_inds`` (B, N) is -1 for
ignore, 0 for negative, k > 0 for matched to gt k - 1.
"""
from __future__ import annotations

import torch

from ...registry import BBOX_ASSIGNERS
from .iou import bbox_overlaps


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """``ignore_iof_thr``, ``ignore_wrt_candidates`` and ``gpu_assign_thr``
    are accepted for the configs; the training step passes no ignored boxes,
    as in the JAX package's. ``gt_max_assign_all=False`` and a (lo, hi)
    ``neg_iou_thr`` (SSD-style configs) are not ported yet."""

    def __init__(self, pos_iou_thr, neg_iou_thr, min_pos_iou=0.0,
                 gt_max_assign_all=True, ignore_iof_thr=-1,
                 ignore_wrt_candidates=True, match_low_quality=True,
                 gpu_assign_thr=-1):
        if not gt_max_assign_all or isinstance(neg_iou_thr, (tuple, list)):
            raise NotImplementedError(
                'MaxIoUAssigner: gt_max_assign_all=False and a (lo, hi) '
                'neg_iou_thr are not ported')
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.match_low_quality = match_low_quality

    def assign(self, bboxes, gt_bboxes, gt_valid, box_valid=None):
        """Returns dict(assigned_gt_inds (B, N) int64, max_overlaps (B, N)
        f32)."""
        overlaps = bbox_overlaps(gt_bboxes, bboxes)           # (B, G, N)
        return self.assign_from_overlaps(overlaps, gt_valid, box_valid)

    def assign_from_overlaps(self, overlaps, gt_valid, box_valid=None):
        valid = gt_valid[..., :, None]
        overlaps = torch.where(valid, overlaps, -1.0)
        max_overlaps = overlaps.amax(dim=-2)
        argmax_overlaps = overlaps.argmax(dim=-2)     # the first maximum
        # for the negative test padded gts look like overlap 0, not -1: an
        # image without gts has negatives, not ignored boxes
        neg_overlaps = torch.where(valid, overlaps, 0.0).amax(dim=-2)

        assigned = torch.full_like(argmax_overlaps, -1)
        neg = (neg_overlaps >= 0) & (neg_overlaps < self.neg_iou_thr)
        assigned = torch.where(neg, 0, assigned)
        pos = max_overlaps >= self.pos_iou_thr
        assigned = torch.where(pos, argmax_overlaps + 1, assigned)

        if self.match_low_quality:
            # each gt's best boxes; a box best for several gts takes the
            # last of them, as the reference's loop over gts does
            gt_max = overlaps.amax(dim=-1, keepdim=True)      # (B, G, 1)
            is_best = (overlaps == gt_max) & (gt_max >= self.min_pos_iou) \
                & valid
            gt_ids = torch.arange(1, overlaps.shape[-2] + 1,
                                  device=overlaps.device)[:, None]
            lq = torch.where(is_best, gt_ids, 0).amax(dim=-2)
            assigned = torch.where(lq > 0, lq, assigned)

        if box_valid is not None:
            assigned = torch.where(box_valid, assigned, -1)
        return dict(assigned_gt_inds=assigned, max_overlaps=max_overlaps)


def scale_boxes(bboxes, scale):
    """Boxes (..., 4) scaled by ``scale`` about their centres."""
    cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
    cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
    wh = (bboxes[..., 2] - bboxes[..., 0]) * 0.5 * scale
    hh = (bboxes[..., 3] - bboxes[..., 1]) * 0.5 * scale
    return torch.stack([cx - wh, cy - hh, cx + wh, cy + hh], dim=-1)


@BBOX_ASSIGNERS.register_module()
class CenterRegionAssigner:
    """A box is positive for a gt whose box holds its centre and whose core
    (the gt scaled by ``pos_scale``) it overlaps by more than
    ``min_pos_iof`` of its own area; among several such gts the one whose
    rank in descending area order is largest wins (the reference uses the
    ranks of ``argsort`` as priorities, and so does the JAX package). The
    (box, gt) pairs of the gts' shadows (scaled by ``neg_scale``) outside
    the core, and the core matches not chosen, are shadowed: the dense
    (B, N, G) ``shadowed_mat`` of the JAX package, where the reference has
    an index list. The reference's "shadowed for its own class wins over
    positive" is FSAF's head's (it knows the classes). Ignored gts are not
    passed by the training step and are not ported."""

    def __init__(self, pos_scale, neg_scale, min_pos_iof=1e-2,
                 ignore_gt_scale=0.5, iou_calculator=None):
        self.pos_scale = pos_scale
        self.neg_scale = neg_scale
        self.min_pos_iof = min_pos_iof
        self.ignore_gt_scale = ignore_gt_scale

    def assign(self, bboxes, gt_bboxes, gt_valid, gt_labels=None,
               box_valid=None):
        """Returns dict(assigned_gt_inds (B, N), labels (B, N) (-1 where
        none; with ``gt_labels``), shadowed_mat (B, N, G) bool)."""
        g = gt_bboxes.shape[-2]
        gv = gt_valid[..., None, :]
        centers = (bboxes[..., 2:4] + bboxes[..., 0:2]) * 0.5
        cx, cy = centers[..., :, None, 0], centers[..., :, None, 1]
        gt = gt_bboxes[..., None, :, :]
        in_gt = (cx > gt[..., 0]) & (cx < gt[..., 2]) & (cy > gt[..., 1]) \
            & (cy < gt[..., 3])
        core_iof = bbox_overlaps(bboxes, scale_boxes(gt_bboxes,
                                                     self.pos_scale),
                                 mode='iof')
        in_core = in_gt & (core_iof > self.min_pos_iof) & gv
        shadow_iof = bbox_overlaps(bboxes, scale_boxes(gt_bboxes,
                                                       self.neg_scale),
                                   mode='iof')
        in_shadow = (shadow_iof > self.min_pos_iof) & gv & ~in_core

        areas = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) \
            * (gt_bboxes[..., 3] - gt_bboxes[..., 1])
        areas = torch.where(gt_valid, areas, float('-inf'))
        priority = torch.argsort(-areas, dim=-1, stable=True)    # (B, G)
        pair_pri = torch.where(in_core, priority[..., None, :], -1)
        best_g = pair_pri.argmax(dim=-1)                         # (B, N)
        matched = in_core.any(dim=-1)
        assigned = torch.where(matched, best_g + 1, 0)
        chosen = (torch.arange(g, device=bboxes.device) == best_g[..., None]) \
            & matched[..., None]
        shadowed = in_shadow | (in_core & ~chosen)

        labels = None
        if gt_labels is not None:
            safe = torch.clamp(assigned - 1, 0, g - 1)
            labels = torch.where(assigned > 0,
                                 torch.gather(gt_labels.long(), -1, safe), -1)
        if box_valid is not None:
            assigned = torch.where(box_valid, assigned, -1)
            shadowed = shadowed & box_valid[..., None]
        return dict(assigned_gt_inds=assigned, labels=labels,
                    shadowed_mat=shadowed)
