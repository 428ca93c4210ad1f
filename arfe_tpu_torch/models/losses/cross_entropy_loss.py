"""Softmax and sigmoid cross entropy (counterpart of
``arfe_tpu/models/losses/cross_entropy_loss.py:23-55,108-134``). ARFE's
``use_dis`` / ``use_multi_cls`` variants and the mask loss are not ported
yet."""
from __future__ import annotations

import torch

from ...registry import LOSSES
from .utils import weight_reduce_loss


def cross_entropy(pred, label, weight=None, reduction='mean',
                  avg_factor=None):
    """Softmax CE over the last dim of ``pred`` against int labels; labels
    outside [0, C) are clamped into it."""
    logp = torch.log_softmax(pred, dim=-1)
    idx = torch.clamp(label.long(), 0, pred.shape[-1] - 1)
    loss = -torch.gather(logp, -1, idx[..., None])[..., 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy(pred, label, weight=None, reduction='mean',
                         avg_factor=None):
    """Sigmoid CE with logits. A ``label`` with one dim fewer than ``pred``
    is broadcast over a single-logit ``pred``, or else read as class
    indices, ``label - 1`` being the positive class (0 = background)."""
    if pred.dim() != label.dim():
        if pred.shape[-1] == 1:
            label = label[..., None]
            if weight is not None and weight.dim() != pred.dim():
                weight = weight[..., None]
        else:
            classes = torch.arange(pred.shape[-1], device=pred.device)
            label = (label[..., None] - 1 == classes) & (label[..., None] >= 1)
            if weight is not None and weight.dim() != pred.dim():
                weight = weight[..., None].expand(pred.shape)
    label = label.to(pred.dtype)
    loss = torch.relu(pred) - pred * label \
        + torch.log1p(torch.exp(-torch.abs(pred)))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(self, use_sigmoid=False, use_mask=False, use_dis=False,
                 use_multi_cls=False, reduction='mean', loss_weight=1.0):
        if use_mask or use_dis or use_multi_cls:
            raise NotImplementedError('CrossEntropyLoss: only the softmax '
                                      'and sigmoid forms are ported')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.cls_criterion = binary_cross_entropy if use_sigmoid \
            else cross_entropy

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * self.cls_criterion(
            cls_score, label, weight, reduction=reduction,
            avg_factor=avg_factor)
