"""Loss reduction (counterpart of ``arfe_tpu/models/losses/utils.py``)."""
from __future__ import annotations

import torch


def reduce_loss(loss, reduction):
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'invalid reduction {reduction}')


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    """Multiply by the element-wise ``weight``, then reduce; with an
    ``avg_factor`` the mean is the sum over ``max(avg_factor, 1e-6)``."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / torch.clamp(
            torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device),
            min=1e-6)
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor only supported with mean reduction')
