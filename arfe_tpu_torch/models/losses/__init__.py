"""Losses of the training steps (counterpart of
``arfe_tpu/models/losses/``); importing this registers them in ``LOSSES``."""
from .accuracy import accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy, distribution_loss,
                                 mask_cross_entropy, multi_classes_loss)
from .focal_loss import FocalLoss, py_sigmoid_focal_loss
from .iou_loss import (AIoULoss, BoundedIoULoss, GIoULoss, IoULoss,
                       aiou_loss, bounded_iou_loss, giou_loss, iou_loss)
from .smooth_l1_loss import (BalancedL1Loss, L1Loss, SmoothL1Loss,
                             balanced_l1_loss, l1_loss, smooth_l1_loss)
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['AIoULoss', 'BalancedL1Loss', 'BoundedIoULoss',
           'CrossEntropyLoss', 'FocalLoss', 'GIoULoss', 'IoULoss', 'L1Loss',
           'SmoothL1Loss', 'accuracy', 'aiou_loss', 'balanced_l1_loss',
           'binary_cross_entropy', 'bounded_iou_loss', 'cross_entropy',
           'distribution_loss', 'giou_loss', 'iou_loss', 'l1_loss',
           'mask_cross_entropy',
           'multi_classes_loss', 'py_sigmoid_focal_loss', 'reduce_loss',
           'smooth_l1_loss', 'weight_reduce_loss']
