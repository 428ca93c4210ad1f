"""Sigmoid focal loss (counterpart of
``arfe_tpu/models/losses/focal_loss.py:16-51``; the reference's Python
version, mmdet/models/losses/focal_loss.py:10-26, is the spec)."""
from __future__ import annotations

import torch

from ...registry import LOSSES
from .utils import weight_reduce_loss


def py_sigmoid_focal_loss(pred, target, weight=None, gamma=2.0, alpha=0.25,
                          reduction='mean', avg_factor=None):
    """pred: (N, C) logits; target: (N,) int labels in [0, C], where C is
    the background (an all-zero row), or (N, C) one-hot floats. A (N,)
    ``weight`` weighs each row."""
    if target.dim() == pred.dim() - 1:
        # a comparison, where F.one_hot would raise on the background label
        classes = torch.arange(pred.shape[-1], device=pred.device)
        onehot = (target.long()[..., None] == classes).to(pred.dtype)
    else:
        onehot = target.to(pred.dtype)
    p = torch.sigmoid(pred)
    pt = (1 - p) * onehot + p * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) \
        * pt.pow(gamma)
    bce = torch.clamp(pred, min=0) - pred * onehot \
        + torch.log1p(torch.exp(-pred.abs()))
    if weight is not None and weight.dim() == 1:
        weight = weight[:, None]
    return weight_reduce_loss(bce * focal_weight, weight, reduction,
                              avg_factor)


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25,
                 reduction='mean', loss_weight=1.0):
        if not use_sigmoid:
            raise NotImplementedError('only the sigmoid focal loss exists')
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        """The loss of ``pred`` in f32 (``force_fp32`` in the reference)."""
        reduction = reduction_override or self.reduction
        return self.loss_weight * py_sigmoid_focal_loss(
            pred.float(), target, weight, self.gamma, self.alpha, reduction,
            avg_factor)
