"""One training step on one card (counterpart of
``arfe_tpu/train/train_step.py:16-60``): forward, losses, backward, the
gradient clip, SGD."""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import build_grad_clip


def parse_losses(losses):
    """The total of every entry whose name holds ``loss``, and the log
    values: every entry (e.g. ``acc``) and the total as ``loss``."""
    log_vars = {}
    total = 0.0
    for name, value in losses.items():
        if isinstance(value, (list, tuple)):
            value = sum(value)
        log_vars[name] = value
        if 'loss' in name:
            total = total + value
    log_vars['loss'] = total
    return total, log_vars


def iteration_generator(seed, global_it, device):
    """The samplers' ``torch.Generator`` of iteration ``global_it`` of a run
    seeded with ``seed``, on ``device``: its state depends on nothing else,
    so a resumed run draws what the uninterrupted run would have drawn (the
    counterpart of ``jax.random.fold_in(key, global_it)``,
    ``arfe_tpu/apis/train.py:160-176``)."""
    state = np.random.SeedSequence([seed, global_it]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model, optimizer, scheduler=None, grad_clip=None):
    """``step(batch, gen) -> log_vars``.

    ``batch`` holds ``img`` (B, H, W, 3), ``img_shape`` (B, 2),
    ``gt_bboxes`` (B, G, 4), ``gt_valid`` (B, G) and ``gt_labels`` (B, G),
    and for a mask head ``gt_mask_crops`` (B, G, cs, cs), on the model's
    device; ``gen`` is the ``torch.Generator`` of the
    samplers. ``grad_clip`` (``dict(max_norm, norm_type=2)``) clips the
    gradients between the backward and the update (``optimizer.
    build_grad_clip``). The log values are detached f32 scalars on the
    device (no host synchronisation).
    """
    clip = build_grad_clip(grad_clip, optimizer)

    def step(batch, gen):
        losses = model.forward_train(
            batch['img'], batch['img_shape'], batch['gt_bboxes'],
            batch['gt_valid'], batch['gt_labels'], gen,
            gt_mask_crops=batch.get('gt_mask_crops'))
        total, log_vars = parse_losses(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if clip is not None:
            clip()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach().float() for k, v in log_vars.items()}

    return step
