"""Delta (dx, dy, dw, dh) box coder (counterpart of
``arfe_tpu/core/bbox/coder.py:16-100``)."""
from __future__ import annotations

import numpy as np
import torch

from ...registry import BBOX_CODERS


def bbox2delta(proposals, gt, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.)):
    """Encode gt boxes (..., 4) as f32 deltas against proposals (..., 4);
    zero widths and heights are floored at 1e-6 so padded rows stay finite."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = torch.clamp(proposals[..., 2] - proposals[..., 0], min=1e-6)
    ph = torch.clamp(proposals[..., 3] - proposals[..., 1], min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(torch.clamp(gw, min=1e-6) / pw)
    dh = torch.log(torch.clamp(gh, min=1e-6) / ph)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2bbox(rois, deltas, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16 / 1000):
    """Decode deltas on top of rois.

    Args:
        rois: (..., n, 4); deltas: (..., n, 4 * k), k boxes per roi.
        max_shape: optional (..., 2) tensor of (h, w) to clamp to,
            broadcast over n.
    Returns:
        (..., n, 4 * k) boxes.
    """
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4))
    d = d * d.new_tensor(stds) + d.new_tensor(means)
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = float(np.abs(np.log(wh_ratio_clip)))
    dw = torch.clamp(dw, -max_ratio, max_ratio)
    dh = torch.clamp(dh, -max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        # (..., 2) -> (..., 1, 1): one clamp per image for its n rois, k boxes
        mh = max_shape[..., 0, None, None]
        mw = max_shape[..., 1, None, None]
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        x1 = torch.minimum(torch.maximum(x1, zero), mw)
        y1 = torch.minimum(torch.maximum(y1, zero), mh)
        x2 = torch.minimum(torch.maximum(x2, zero), mw)
        y2 = torch.minimum(torch.maximum(y2, zero), mh)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


@BBOX_CODERS.register_module()
class DeltaXYWHBBoxCoder:
    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.)):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def encode(self, bboxes, gt_bboxes):
        return bbox2delta(bboxes, gt_bboxes, self.means, self.stds)

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        return delta2bbox(bboxes, pred_bboxes, self.means, self.stds,
                          max_shape, wh_ratio_clip)
