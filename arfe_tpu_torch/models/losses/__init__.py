"""Losses of the flagship's training step (counterpart of
``arfe_tpu/models/losses/``); importing this registers them in ``LOSSES``."""
from .accuracy import accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy, distribution_loss,
                                 multi_classes_loss)
from .smooth_l1_loss import L1Loss, SmoothL1Loss, l1_loss, smooth_l1_loss
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['CrossEntropyLoss', 'L1Loss', 'SmoothL1Loss', 'accuracy',
           'binary_cross_entropy', 'cross_entropy', 'distribution_loss',
           'l1_loss', 'multi_classes_loss', 'reduce_loss', 'smooth_l1_loss',
           'weight_reduce_loss']
