"""IoU-based box regression losses (counterpart of
``arfe_tpu/models/losses/iou_loss.py:13-103``): the IoU loss -log(IoU), the
generalised IoU loss, ARFE's aspect-aware IoU loss and the bounded IoU
loss, each over (n, 4) boxes [x1, y1, x2, y2], with a loss class of the
``LOSSES`` registry."""
from __future__ import annotations

import math

import torch

from ...core.bbox.iou import bbox_overlaps
from ...registry import LOSSES
from .utils import weight_reduce_loss


def iou_loss(pred, target, eps=1e-6):
    ious = torch.clamp(bbox_overlaps(pred, target, is_aligned=True), min=eps)
    return -torch.log(ious)


def giou_loss(pred, target, eps=1e-7):
    ious = bbox_overlaps(pred, target, is_aligned=True)
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    enclose = wh[..., 0] * wh[..., 1] + eps
    area_p = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    area_t = (target[..., 2] - target[..., 0]) \
        * (target[..., 3] - target[..., 1])
    inter_lt = torch.maximum(pred[..., :2], target[..., :2])
    inter_rb = torch.minimum(pred[..., 2:], target[..., 2:])
    inter_wh = torch.clamp(inter_rb - inter_lt, min=0)
    union = area_p + area_t - inter_wh[..., 0] * inter_wh[..., 1] + eps
    return 1 - (ious - (enclose - union) / enclose)


def bounded_iou_loss(pred, target, beta=0.2, eps=1e-3):
    """The four smooth-L1-shaped terms (n, 4) of the bounded IoU loss
    (centre x, centre y, width, height)."""
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    dx, dy = torch.abs(tx - px), torch.abs(ty - py)
    loss_dx = 1 - torch.clamp((tw - 2 * dx) / (tw + 2 * dx + eps), min=0)
    loss_dy = 1 - torch.clamp((th - 2 * dy) / (th + 2 * dy + eps), min=0)
    loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)


def aiou_loss(pred, target, eps=1e-7):
    """ARFE's aspect-aware IoU loss: |1 - IoU| + cos((w ratio + h ratio)
    * pi / 4)."""
    ious = bbox_overlaps(pred, target, is_aligned=True)
    w_pre = torch.abs(pred[..., 2] - pred[..., 0])
    h_pre = torch.abs(pred[..., 3] - pred[..., 1])
    w_tar = torch.abs(target[..., 2] - target[..., 0])
    h_tar = torch.abs(target[..., 3] - target[..., 1])
    w_ratio = torch.minimum(w_pre, w_tar) / (torch.maximum(w_pre, w_tar)
                                             + eps)
    h_ratio = torch.minimum(h_pre, h_tar) / (torch.maximum(h_pre, h_tar)
                                             + eps)
    return torch.abs(1 - ious) + torch.cos((w_ratio + h_ratio) * math.pi
                                           * 0.25)


class _IoULossBase:
    """A loss class over one of the functions above: ``fn`` and the extra
    keyword arguments it takes from the config (``extra``)."""
    fn = None
    extra = ()

    def __init__(self, eps=1e-6, reduction='mean', loss_weight=1.0,
                 **kwargs):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.kwargs = {k: kwargs[k] for k in self.extra if k in kwargs}

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        loss = type(self).fn(pred, target, eps=self.eps, **self.kwargs)
        if weight is not None:
            # (n, 4) box weights against (n,) losses and the other way round
            while weight.dim() > loss.dim():
                weight = weight.mean(-1)
            if weight.dim() < loss.dim():
                weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class IoULoss(_IoULossBase):
    fn = iou_loss


@LOSSES.register_module()
class GIoULoss(_IoULossBase):
    fn = giou_loss


@LOSSES.register_module()
class AIoULoss(_IoULossBase):
    fn = aiou_loss


@LOSSES.register_module()
class BoundedIoULoss(_IoULossBase):
    fn = bounded_iou_loss
    extra = ('beta',)
