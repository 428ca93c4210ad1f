"""SGD and its LR schedule (counterpart of
``arfe_tpu/train/optimizer.py:46-94,185-240``).

``torch.optim.SGD`` follows the JAX package's optax chain: the weight decay
is added to the gradient before the momentum trace, the trace starts as that
sum, and the update is ``-lr(it) * trace`` with the first step at
``lr(0)``. Frozen parameters (by config prefix, or ``requires_grad`` off)
are left out of the optimizer: they neither move nor decay. Every other
parameter decays, BatchNorm's affine weight and bias included; BatchNorm's
running statistics are buffers. ``grad_clip`` is optax's
``clip_by_global_norm`` over the trainable gradients, before the weight
decay and the momentum (:func:`build_grad_clip`). ``paramwise_cfg`` and the
Adam / RMSprop optimizers are not ported yet.
"""
from __future__ import annotations

import torch


def frozen_prefixes_from_cfg(model_cfg):
    """Parameter-name prefixes a detector config freezes: the stem and
    stages 1..k of a backbone with ``frozen_stages = k``."""
    out = []
    bb = model_cfg.get('backbone', {})
    fs = bb.get('frozen_stages', -1)
    if fs >= 0:
        if bb.get('deep_stem', False) or bb.get('type') == 'ResNetV1d':
            out.append('backbone.stem')
        else:
            out += ['backbone.conv1', 'backbone.bn1']
    for i in range(1, fs + 1):
        out.append(f'backbone.layer{i}')
    return out


def build_lr_schedule(lr_config, base_lr, iters_per_epoch):
    """``schedule(it) -> lr``: the step policy (or a fixed LR) with a
    linear, constant or exp warmup, as mmcv's LR hooks set it."""
    cfg = dict(lr_config or {})
    policy = cfg.get('policy', 'step')
    warmup = cfg.get('warmup', None)
    warmup_iters = cfg.get('warmup_iters', 500)
    warmup_ratio = cfg.get('warmup_ratio', 0.1)
    boundaries = [s * iters_per_epoch for s in cfg.get('step', [])]
    gamma = cfg.get('gamma', 0.1)
    if policy not in ('step', 'fixed'):
        raise KeyError(f'unsupported lr policy {policy}')
    if warmup not in (None, 'linear', 'constant', 'exp'):
        raise KeyError(f'unsupported warmup {warmup}')

    def schedule(it):
        lr = base_lr
        if policy == 'step':
            lr = base_lr * gamma ** sum(it >= b for b in boundaries)
        if it < warmup_iters:
            if warmup == 'linear':
                k = min(max(it / warmup_iters, 0.0), 1.0)
                lr = base_lr * (warmup_ratio * (1 - k) + k) * (lr / base_lr)
            elif warmup == 'constant':
                lr = base_lr * warmup_ratio
            elif warmup == 'exp':
                lr = base_lr * warmup_ratio ** (1 - it / warmup_iters)
        return lr

    return schedule


def build_optimizer(optimizer_cfg, lr_schedule, model, frozen_prefixes=()):
    """``(optimizer, scheduler)`` for the trainable parameters of ``model``.

    ``optimizer_cfg`` e.g. ``dict(type='SGD', lr=0.02, momentum=0.9,
    weight_decay=0.0001)``; its ``lr`` is replaced by ``lr_schedule``, which
    ``scheduler.step()`` advances once per iteration.
    """
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'SGD')
    cfg.pop('lr', None)
    if opt_type != 'SGD':
        raise KeyError(f'unsupported optimizer {opt_type}')
    if cfg.pop('paramwise_cfg', None):
        raise NotImplementedError('paramwise_cfg is not ported')
    params = [p for name, p in model.named_parameters()
              if p.requires_grad
              and not any(name.startswith(f) for f in frozen_prefixes)]
    # lr 1.0 scaled by the schedule: the LR of iteration it is
    # lr_schedule(it) itself
    optimizer = torch.optim.SGD(
        params, lr=1.0, momentum=cfg.pop('momentum', 0.0),
        weight_decay=cfg.pop('weight_decay', 0.0),
        nesterov=cfg.pop('nesterov', False))
    if cfg:
        raise KeyError(f'unsupported SGD options {sorted(cfg)}')
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_schedule)
    return optimizer, scheduler


def build_grad_clip(grad_clip, optimizer):
    """``clip() -> norm`` for the config's ``optimizer_config.grad_clip``
    (``dict(max_norm, norm_type=2)``), or ``None`` without one.

    ``clip`` scales the gradients of ``optimizer``'s parameters (the
    trainable ones) as ``optax.clip_by_global_norm`` does: by ``max_norm /
    norm`` where their global 2-norm ``norm`` passes ``max_norm``, computed
    as ``(g / norm) * max_norm``, and not at all otherwise (``torch.nn.
    utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` whenever
    that is below 1). It returns the norm, on the device, without a host
    synchronisation.
    """
    if not grad_clip:
        return None
    cfg = dict(grad_clip)
    max_norm = float(cfg.pop('max_norm'))
    norm_type = cfg.pop('norm_type', 2)
    if norm_type != 2 or cfg:
        raise NotImplementedError(
            f'grad_clip: only the global 2-norm is ported, got '
            f'norm_type={norm_type!r} and {sorted(cfg)}')
    params = [p for group in optimizer.param_groups for p in group['params']]

    def clip():
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            grads)))
        keep = norm < max_norm
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
        return norm

    return clip
