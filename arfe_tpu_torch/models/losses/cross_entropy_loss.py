"""Softmax and sigmoid cross entropy, and ARFE's ``use_dis`` and
``use_multi_cls`` variants (counterpart of
``arfe_tpu/models/losses/cross_entropy_loss.py:23-55,68-134``). The mask loss
is not ported yet.

Maxima and minima are ``amax`` / ``amin``, whose gradient splits a tie
evenly, as JAX's does."""
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


def distribution_loss(pred, label, weight=None, reduction='mean',
                      avg_factor=None):
    """Softmax CE plus a penalty on peaked class distributions
    (``use_dis``): the softmax over its maximum, the maximum itself zeroed,
    gives ``1 - min((2 max - p) * (1 - tanh p)) / 2`` per row, averaged."""
    soft = torch.softmax(pred, dim=-1)
    soft = soft / (soft.amax(dim=-1, keepdim=True) + 1e-9)
    max_pred = soft.amax(dim=-1, keepdim=True)
    soft = torch.where(soft == max_pred, torch.zeros_like(soft), soft)
    dis = 1.0 - (torch.amin((max_pred * 2.0 - soft)
                            * (1.0 - torch.tanh(soft)), dim=-1) * 0.5)
    return cross_entropy(pred, label, weight, reduction, avg_factor) \
        + dis.mean()


def multi_classes_loss(pred, presence, weight=None, reduction='mean',
                       avg_factor=None):
    """Image-level class-presence hinge (``use_multi_cls``, the "+fac"
    head's loss).

    Args:
        pred: (..., C, 2) background / foreground logits of each class.
        presence: (..., C) multi-hot of the classes present in the image.
    Returns:
        (...) the mean of the worst present class's ``tanh(1 - p) + [p <
        0.5]`` and the worst absent class's ``tanh(p) + [p > 0.5]``, ``p``
        the foreground probability.
    """
    pd = torch.softmax(pred.reshape(presence.shape + (2,)), dim=-1)[..., 1]
    ori = presence.to(pd.dtype)
    pos = torch.where(ori == 1, torch.tanh(1 - pd) + (pd < 0.5).to(pd.dtype),
                      ori)
    neg = torch.where(ori == 0, torch.tanh(pd) + (pd > 0.5).to(pd.dtype),
                      torch.zeros_like(ori))
    return (pos.amax(dim=-1) + neg.amax(dim=-1)) * 0.5


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(self, use_sigmoid=False, use_mask=False, use_dis=False,
                 use_multi_cls=False, reduction='mean', loss_weight=1.0):
        if use_mask:
            raise NotImplementedError('CrossEntropyLoss: the mask form is '
                                      'not ported')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight
        if use_sigmoid:
            self.cls_criterion = binary_cross_entropy
        elif use_dis:
            self.cls_criterion = distribution_loss
        elif use_multi_cls:
            self.cls_criterion = multi_classes_loss
        else:
            self.cls_criterion = cross_entropy

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * self.cls_criterion(
            cls_score, label, weight, reduction=reduction,
            avg_factor=avg_factor)
