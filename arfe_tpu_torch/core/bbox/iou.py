"""Pairwise box IoU (counterpart of ``arfe_tpu/core/bbox/iou.py``)."""
from __future__ import annotations

import torch

EPS = 1e-6


def bbox_overlaps(bboxes1, bboxes2):
    """IoU of (..., m, 4) against (..., n, 4) boxes -> (..., m, n); zero-area
    boxes overlap nothing."""
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (
        bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (
        bboxes2[..., 3] - bboxes2[..., 1])
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:4], bboxes2[..., None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / torch.clamp(union, min=EPS)
