"""Proposal recall (counterpart of ``arfe_tpu/core/evaluation/recall.py:
1-68``, with its own copy of ``bbox_overlaps_np`` from
``arfe_tpu/core/evaluation/mean_ap.py:12``; ref:
mmdet/core/evaluation/recall.py): for each budget of proposals, the share
of gts that a greedy one-to-one matching of gts to proposals (the largest
IoU first) covers at each IoU threshold."""
from __future__ import annotations

import numpy as np


def bbox_overlaps_np(bboxes1, bboxes2):
    """IoU of (m, 4) against (n, 4) boxes, in float64 -> (m, n)."""
    bboxes1 = bboxes1.astype(np.float64)
    bboxes2 = bboxes2.astype(np.float64)
    rows, cols = bboxes1.shape[0], bboxes2.shape[0]
    if rows * cols == 0:
        return np.zeros((rows, cols))
    x1 = np.maximum(bboxes1[:, None, 0], bboxes2[None, :, 0])
    y1 = np.maximum(bboxes1[:, None, 1], bboxes2[None, :, 1])
    x2 = np.minimum(bboxes1[:, None, 2], bboxes2[None, :, 2])
    y2 = np.minimum(bboxes1[:, None, 3], bboxes2[None, :, 3])
    overlap = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area1 = (bboxes1[:, 2] - bboxes1[:, 0]) * (bboxes1[:, 3] - bboxes1[:, 1])
    area2 = (bboxes2[:, 2] - bboxes2[:, 0]) * (bboxes2[:, 3] - bboxes2[:, 1])
    union = area1[:, None] + area2[None, :] - overlap
    return overlap / np.maximum(union, np.finfo(np.float64).eps)


def _matched_ious(ious):
    """Each gt's IoU in the greedy one-to-one matching of gts (rows) to
    proposals: repeatedly the pair of largest IoU, both then taken out."""
    gt_ious = np.zeros(ious.shape[0])
    for j in range(ious.shape[0]):
        gt_max_overlaps = ious.argmax(axis=1)
        max_ious = ious[np.arange(ious.shape[0]), gt_max_overlaps]
        gt_idx = max_ious.argmax()
        gt_ious[j] = max_ious[gt_idx]
        ious[gt_idx, :] = -1
        ious[:, gt_max_overlaps[gt_idx]] = -1
    return gt_ious


def _recalls(all_ious, proposal_nums, thrs):
    """The JAX package's loop, with its quirk: an image whose IoU matrix is
    empty (no gts, or no proposals) puts its zeros into the list of
    budgets' IoUs itself, not into its budget's, so the budgets after it
    read the IoUs of the one before (mmdet adds them to the budget's)."""
    total_gt_num = sum(ious.shape[0] for ious in all_ious)
    ious_list = []
    for k in proposal_nums:
        tmp_ious = np.zeros(0)
        for ious in all_ious:
            ious = ious[:, :k].copy()
            if ious.size == 0:
                ious_list.append(np.zeros(ious.shape[0]))
                continue
            tmp_ious = np.hstack((tmp_ious, _matched_ious(ious)))
        ious_list.append(tmp_ious)
    recalls = np.zeros((len(proposal_nums), len(thrs)))
    for i, tious in enumerate(ious_list[:len(proposal_nums)]):
        recalls[i, :] = [(np.asarray(tious) >= thr).sum()
                         / max(total_gt_num, 1) for thr in thrs]
    return recalls


def eval_recalls(gts, proposals, proposal_nums=None, iou_thrs=0.5):
    """Recalls (len(proposal_nums), len(iou_thrs)).

    Args:
        gts: per image an (m, 4) array of gt boxes (or None).
        proposals: per image an (n, 4) array, or (n, 5) with scores, which
            then orders them (descending).
        proposal_nums: the budgets (default 100, 300, 1000).
        iou_thrs: a threshold or a sequence of them.
    """
    proposal_nums = np.array([100, 300, 1000] if proposal_nums is None
                             else proposal_nums, dtype=np.int32)
    iou_thrs = np.array([iou_thrs]) if isinstance(iou_thrs, float) \
        else np.asarray(iou_thrs)
    if len(gts) != len(proposals):
        raise ValueError('eval_recalls: one proposal array an image')
    all_ious = []
    for gt, props in zip(gts, proposals):
        if props.shape[1] == 5:
            props = props[np.argsort(-props[:, 4]), :4]
        prop_num = min(props.shape[0], proposal_nums[-1])
        if gt is None or gt.shape[0] == 0:
            ious = np.zeros((0, props.shape[0]), dtype=np.float32)
        else:
            ious = bbox_overlaps_np(gt, props[:prop_num, :4])
        all_ious.append(ious)
    return _recalls(all_ious, proposal_nums, iou_thrs)
