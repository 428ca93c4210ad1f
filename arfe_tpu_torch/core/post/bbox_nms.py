"""Multi-class NMS with static shapes (counterpart of
``arfe_tpu/core/post/bbox_nms.py``), batched over images."""
from __future__ import annotations

import torch

from ...ops.nms import batched_nms_batched


def multiclass_nms(multi_bboxes, multi_scores, score_thr, nms_cfg, max_num,
                   pre_nms_cap=2000, valid_mask=None):
    """NMS over (box, class) candidates of each image.

    Args:
        multi_bboxes: (B, n, num_classes * 4) class-wise or (B, n, 4) boxes.
        multi_scores: (B, n, num_classes + 1); the last (background) column
            is ignored.
        score_thr: candidates at or below it are dropped.
        max_num: output capacity per image.
        pre_nms_cap: the top candidates by score that enter NMS.
        valid_mask: optional (B, n) row validity.
    Returns:
        dets (B, max_num, 5) padded with [0, 0, 0, 0, -1], labels
        (B, max_num) int32 (padding 0), valid (B, max_num) bool.
    """
    b, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[2] - 1
    if multi_bboxes.shape[-1] > 4:
        bboxes = multi_bboxes.reshape(b, n, num_classes, 4)
    else:
        bboxes = multi_bboxes[:, :, None, :].expand(b, n, num_classes, 4)
    scores = multi_scores[..., :-1]
    cand_valid = scores > score_thr
    if valid_mask is not None:
        cand_valid = cand_valid & valid_mask[..., None]

    flat_scores = scores.reshape(b, -1)
    flat_boxes = bboxes.reshape(b, -1, 4)
    flat_labels = torch.arange(num_classes, dtype=torch.int32,
                               device=scores.device).repeat(n)
    cap = min(pre_nms_cap, flat_scores.shape[1])
    masked = torch.where(cand_valid.reshape(b, -1), flat_scores,
                         float('-inf'))
    # stable: ties in (box, class) order, as jax.lax.top_k
    neg_top, top_idx = torch.sort(-masked, dim=1, stable=True)
    top_scores, top_idx = -neg_top[:, :cap], top_idx[:, :cap]
    top_valid = torch.isfinite(top_scores)
    top_boxes = torch.gather(flat_boxes, 1, top_idx[..., None].expand(
        b, cap, 4)) * top_valid[..., None]
    top_labels = flat_labels[top_idx]

    dets, keep_idx, out_valid = batched_nms_batched(
        top_boxes, top_scores, top_labels, nms_cfg, max_out=max_num,
        valid_mask=top_valid)
    labels = torch.where(out_valid, torch.gather(top_labels, 1, keep_idx), 0)
    return dets, labels.to(torch.int32), out_valid
