"""The training step of the port (counterpart of ``arfe_tpu/train/``)."""
from .optimizer import (build_lr_schedule, build_optimizer,
                        frozen_prefixes_from_cfg)
from .train_step import make_train_step, parse_losses

__all__ = ['build_lr_schedule', 'build_optimizer', 'frozen_prefixes_from_cfg',
           'make_train_step', 'parse_losses']
