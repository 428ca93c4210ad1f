"""Box IoU and IoF (counterpart of ``arfe_tpu/core/bbox/iou.py``)."""
from __future__ import annotations

import torch

EPS = 1e-6


def bbox_overlaps(bboxes1, bboxes2, mode='iou', is_aligned=False):
    """IoU (or, with ``mode='iof'``, the intersection over the area of
    ``bboxes1``) of (..., m, 4) against (..., n, 4) boxes -> (..., m, n),
    or element by element -> (..., m) with ``is_aligned`` (m == n);
    zero-area boxes overlap nothing."""
    if mode not in ('iou', 'iof'):
        raise ValueError(f'bbox_overlaps: mode {mode!r}')
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (
        bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (
        bboxes2[..., 3] - bboxes2[..., 1])
    if is_aligned:
        lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
        rb = torch.minimum(bboxes1[..., 2:4], bboxes2[..., 2:4])
    else:
        lt = torch.maximum(bboxes1[..., :, None, :2],
                           bboxes2[..., None, :, :2])
        rb = torch.minimum(bboxes1[..., :, None, 2:4],
                           bboxes2[..., None, :, 2:4])
        area1, area2 = area1[..., :, None], area2[..., None, :]
    wh = torch.clamp(rb - lt, min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - overlap if mode == 'iou' \
        else area1.expand_as(overlap)
    return overlap / torch.clamp(union, min=EPS)
