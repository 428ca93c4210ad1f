"""Max-IoU assigner over padded boxes (counterpart of
``arfe_tpu/core/bbox/assigners.py:20-121``, ``MaxIoUAssigner``).

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
