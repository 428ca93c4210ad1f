"""L1 and smooth L1 regression losses (counterpart of
``arfe_tpu/models/losses/smooth_l1_loss.py:13-61``)."""
from __future__ import annotations

import torch

from ...registry import LOSSES
from .utils import weight_reduce_loss


def smooth_l1_loss(pred, target, beta=1.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def l1_loss(pred, target):
    return torch.abs(pred - target)


@LOSSES.register_module()
class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction='mean', loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * weight_reduce_loss(
            smooth_l1_loss(pred, target, self.beta), weight, reduction,
            avg_factor)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * weight_reduce_loss(
            l1_loss(pred, target), weight, reduction, avg_factor)
