"""The training step of the port (counterpart of ``arfe_tpu/train/``)."""
from .optimizer import (build_grad_clip, build_lr_schedule, build_optimizer,
                        frozen_prefixes_from_cfg)
from .train_step import iteration_generator, make_train_step, parse_losses

__all__ = ['build_grad_clip', 'build_lr_schedule', 'build_optimizer',
           'frozen_prefixes_from_cfg', 'iteration_generator',
           'make_train_step', 'parse_losses']
