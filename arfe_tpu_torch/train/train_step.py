"""One training step on one card (counterpart of
``arfe_tpu/train/train_step.py:16-60``): forward, losses, backward, SGD."""
from __future__ import annotations


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


def make_train_step(model, optimizer, scheduler=None):
    """``step(batch, gen) -> log_vars``.

    ``batch`` holds ``img`` (B, H, W, 3), ``img_shape`` (B, 2),
    ``gt_bboxes`` (B, G, 4), ``gt_valid`` (B, G) and ``gt_labels`` (B, G)
    on the model's device; ``gen`` is the ``torch.Generator`` of the
    samplers. The log values are detached f32 scalars on the device (no
    host synchronisation).
    """
    def step(batch, gen):
        losses = model.forward_train(
            batch['img'], batch['img_shape'], batch['gt_bboxes'],
            batch['gt_valid'], batch['gt_labels'], gen)
        total, log_vars = parse_losses(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach().float() for k, v in log_vars.items()}

    return step
