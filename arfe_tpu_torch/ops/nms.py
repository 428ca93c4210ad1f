"""Greedy NMS with fixed output capacity (counterpart of
``arfe_tpu/ops/nms.py:91-175``), in plain PyTorch tensor ops.

The result is exactly sequential greedy NMS: in score order, a box is kept
when no kept box before it overlaps it by more than the threshold. Instead of
a loop over boxes, the keep mask is the fixpoint of
``keep = valid & ~any(keep[i] & suppresses[i, j] for i before j)`` over the
score-sorted boxes, iterated on all boxes at once. Since ``suppresses`` is
strictly upper triangular, each pass fixes at least the next box in order,
and the iteration stops after the first pass that changes nothing; the host
checks that every few passes, not once per box. Problems of one batch are
solved together.

Output contract of the JAX package: ``dets`` (..., max_out, 5) with padding
rows ``[0, 0, 0, 0, -1]``, ``idx`` (..., max_out) int64 into the input
(padding 0), ``valid`` (..., max_out) bool.
"""
from __future__ import annotations

import torch

from ..core.bbox.iou import bbox_overlaps

_PASSES_PER_CHECK = 4


def _greedy_keep(sorted_boxes, valid, iou_threshold):
    """Keep mask of greedy NMS over score-descending (P, N, 4) boxes."""
    n = sorted_boxes.shape[1]
    iou = bbox_overlaps(sorted_boxes, sorted_boxes)
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=sorted_boxes.device).triu(1)
    sup = ((iou > iou_threshold) & earlier).float()   # sup[p, i, j]: i kills j
    keep = valid
    while True:
        prev = keep
        for _ in range(_PASSES_PER_CHECK):
            hit = torch.bmm(keep.float().unsqueeze(1), sup).squeeze(1)
            keep = valid & (hit == 0)
        if torch.equal(keep, prev):
            return keep


def nms_batched(boxes, scores, iou_threshold, max_out=None, valid_mask=None):
    """Independent NMS problems: boxes (P, N, 4), scores (P, N)."""
    p, n = scores.shape
    if max_out is None:
        max_out = n
    scores_m = scores.float()
    if valid_mask is not None:
        scores_m = torch.where(valid_mask, scores_m, float('-inf'))
    # stable sort: ties keep input order, as jnp.argsort does
    neg_sorted, order = torch.sort(-scores_m, dim=1, stable=True)
    sscores = -neg_sorted
    svalid = torch.isfinite(sscores)
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(p, n, 4))
    sboxes = sboxes * svalid[..., None]
    keep = _greedy_keep(sboxes, svalid, iou_threshold)

    kept_scores = torch.where(keep, sscores, float('-inf'))
    k = min(max_out, n)
    neg_top, top_pos = torch.sort(-kept_scores, dim=1, stable=True)
    top_vals, top_pos = -neg_top[:, :k], top_pos[:, :k]
    out_valid = torch.isfinite(top_vals)
    src = torch.gather(order, 1, top_pos)
    idx = torch.where(out_valid, src, 0)
    out_boxes = torch.gather(boxes.float(), 1, src[..., None].expand(p, k, 4))
    out_boxes = out_boxes * out_valid[..., None]
    out_scores = torch.where(out_valid, top_vals, -1.0)
    dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
    if k < max_out:
        pad = max_out - k
        fill = dets.new_tensor([0., 0., 0., 0., -1.]).expand(p, pad, 5)
        dets = torch.cat([dets, fill], dim=1)
        idx = torch.cat([idx, idx.new_zeros(p, pad)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(p, pad)], dim=1)
    return dets, idx, out_valid


def nms(boxes, scores, iou_threshold, max_out=None, valid_mask=None):
    """Hard NMS of (N, 4) boxes; returns dets (max_out, 5), idx, valid."""
    vm = None if valid_mask is None else valid_mask[None]
    dets, idx, valid = nms_batched(boxes[None], scores[None], iou_threshold,
                                   max_out, vm)
    return dets[0], idx[0], valid[0]


def batched_nms_batched(boxes, scores, idxs, nms_cfg, max_out=None,
                        valid_mask=None):
    """Class-wise NMS of independent problems (P, N): boxes of different
    ``idxs`` never suppress each other (coordinate-offset trick)."""
    cfg = dict(nms_cfg)
    nms_type = cfg.pop('type', 'nms')
    if nms_type != 'nms':
        raise NotImplementedError(f'NMS type {nms_type!r} is not ported')
    iou_thr = cfg.pop('iou_thr', None)
    if iou_thr is None:
        iou_thr = cfg.pop('iou_threshold')
    max_coordinate = boxes.flatten(1).amax(dim=1)
    offsets = idxs.to(boxes.dtype) * (max_coordinate[:, None] + 1.0)
    dets, idx, out_valid = nms_batched(boxes + offsets[..., None], scores,
                                       iou_thr, max_out, valid_mask)
    k = idx.shape[1]
    out_boxes = torch.gather(boxes.float(), 1, idx[..., None].expand(-1, k, 4))
    out_boxes = out_boxes * out_valid[..., None]
    return torch.cat([out_boxes, dets[..., 4:5]], dim=-1), idx, out_valid


def batched_nms(boxes, scores, idxs, nms_cfg, max_out=None, valid_mask=None):
    """Class-wise NMS of (N, 4) boxes grouped by ``idxs``."""
    vm = None if valid_mask is None else valid_mask[None]
    dets, idx, valid = batched_nms_batched(boxes[None], scores[None],
                                           idxs[None], nms_cfg, max_out, vm)
    return dets[0], idx[0], valid[0]
