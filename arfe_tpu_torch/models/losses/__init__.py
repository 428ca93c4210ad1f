"""Losses of the training steps (counterpart of
``arfe_tpu/models/losses/``); importing this registers them in ``LOSSES``."""
from .accuracy import accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy, distribution_loss,
                                 mask_cross_entropy, multi_classes_loss)
from .focal_loss import FocalLoss, py_sigmoid_focal_loss
from .smooth_l1_loss import L1Loss, SmoothL1Loss, l1_loss, smooth_l1_loss
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['CrossEntropyLoss', 'FocalLoss', 'L1Loss', 'SmoothL1Loss',
           'accuracy', 'binary_cross_entropy', 'cross_entropy',
           'distribution_loss', 'l1_loss', 'mask_cross_entropy',
           'multi_classes_loss', 'py_sigmoid_focal_loss', 'reduce_loss',
           'smooth_l1_loss', 'weight_reduce_loss']
