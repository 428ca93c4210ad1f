"""Box coders (counterpart of ``arfe_tpu/core/bbox/coder.py:16-230``): the
delta (dx, dy, dw, dh) coders, mmdet 1.x's legacy one among them, and
FSAF's top / bottom / left / right coder."""
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


def legacy_bbox2delta(proposals, gt, means=(0., 0., 0., 0.),
                      stds=(1., 1., 1., 1.)):
    """mmdet 1.x's encoding (``arfe_tpu/core/bbox/coder.py:154-178``): widths
    and heights count the end pixel (+1); floored at 1e-6 as
    :func:`bbox2delta`."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = torch.clamp(proposals[..., 2] - proposals[..., 0] + 1.0, min=1e-6)
    ph = torch.clamp(proposals[..., 3] - proposals[..., 1] + 1.0, min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(torch.clamp(gw, min=1e-6) / pw)
    dh = torch.log(torch.clamp(gh, min=1e-6) / ph)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def legacy_delta2bbox(rois, deltas, means=(0., 0., 0., 0.),
                      stds=(1., 1., 1., 1.), max_shape=None,
                      wh_ratio_clip=16 / 1000):
    """mmdet 1.x's decoding (``arfe_tpu/core/bbox/coder.py:181-215``): the
    +1 widths and heights, corners at the center -+ half the size (mmdet
    1.x's +-0.5 dropped, as there), clamped to [0, max_shape - 1].
    Arguments as :func:`delta2bbox`."""
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4)).float()
    d = d * d.new_tensor(stds) + d.new_tensor(means)
    max_ratio = float(np.abs(np.log(wh_ratio_clip)))
    dx, dy = d[..., 0], d[..., 1]
    dw = torch.clamp(d[..., 2], -max_ratio, max_ratio)
    dh = torch.clamp(d[..., 3], -max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        mh = max_shape[..., 0, None, None] - 1
        mw = max_shape[..., 1, None, None] - 1
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        x1 = torch.minimum(torch.maximum(x1, zero), mw)
        y1 = torch.minimum(torch.maximum(y1, zero), mh)
        x2 = torch.minimum(torch.maximum(x2, zero), mw)
        y2 = torch.minimum(torch.maximum(y2, zero), mh)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


@BBOX_CODERS.register_module()
class LegacyDeltaXYWHBBoxCoder(DeltaXYWHBBoxCoder):
    """The coder of models trained with mmdet 1.x
    (``arfe_tpu/core/bbox/coder.py:218-230``)."""

    def encode(self, bboxes, gt_bboxes):
        return legacy_bbox2delta(bboxes, gt_bboxes, self.means, self.stds)

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        return legacy_delta2bbox(bboxes, pred_bboxes, self.means, self.stds,
                                 max_shape, wh_ratio_clip)


@BBOX_CODERS.register_module()
class TBLRBBoxCoder:
    """Distances from a box's centre to the target's top, bottom, left and
    right sides, over the box's height or width times ``normalizer``
    (``arfe_tpu/core/bbox/coder.py:115-153``; FSAF's)."""

    def __init__(self, normalizer=4.0):
        self.normalizer = normalizer

    @staticmethod
    def _centre_and_size(bboxes):
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        return px, py, torch.stack([h, h, w, w], dim=-1)

    def encode(self, bboxes, gt_bboxes):
        px, py, hhww = self._centre_and_size(bboxes)
        loc = torch.stack([py - gt_bboxes[..., 1], gt_bboxes[..., 3] - py,
                           px - gt_bboxes[..., 0], gt_bboxes[..., 2] - px],
                          dim=-1)
        return loc / (torch.clamp(hhww, min=1e-6) * self.normalizer)

    def decode(self, bboxes, pred_bboxes, max_shape=None):
        """``max_shape``: optional (..., 2) tensor of (h, w) to clamp to,
        broadcast over the boxes' dimension."""
        px, py, hhww = self._centre_and_size(bboxes)
        loc = pred_bboxes * self.normalizer * hhww
        t, b, l, r = loc.unbind(-1)
        x1, y1, x2, y2 = px - l, py - t, px + r, py + b
        if max_shape is not None:
            mh, mw = max_shape[..., 0, None], max_shape[..., 1, None]
            zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
            x1 = torch.minimum(torch.maximum(x1, zero), mw)
            y1 = torch.minimum(torch.maximum(y1, zero), mh)
            x2 = torch.minimum(torch.maximum(x2, zero), mw)
            y2 = torch.minimum(torch.maximum(y2, zero), mh)
        return torch.stack([x1, y1, x2, y2], dim=-1)
