"""The training run on one card (counterpart of ``arfe_tpu/apis/train.py``;
ref: mmdet/apis/train.py:83-179, train_detector with the mmcv Runner's epoch
loop and its LR, optimizer, checkpoint, logger and evaluation hooks).

One epoch loop with the hooks inlined, as in the JAX package: the step LR
with its warm-up, the gradient clip, a log entry every
``log_config.interval`` iterations (text, and ``mode='train'`` lines of
``work_dir/train.log.json``), validation every ``evaluation.interval``
epochs (``mode='val'``), and a ``.pth`` checkpoint with the optimizer and
scheduler states every ``checkpoint_config.interval`` epochs, which
``resume_from`` continues exactly. The loop waits for the card only at the
log iterations: the step's log values stay on the device until then.
"""
from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch

from ..data import build_dataloader, build_dataset
from ..train import (build_lr_schedule, build_optimizer,
                     frozen_prefixes_from_cfg, iteration_generator,
                     make_train_step)
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.pretrained import load_pretrained_backbone
from .test import single_device_test


def set_random_seed(seed, deterministic=False):
    """(ref: apis/train.py:16-32) Seeds Python's, numpy's and torch's
    generators; ``deterministic`` makes cuDNN pick deterministic
    algorithms, without its autotuner."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def _check_supported(cfg):
    if int(os.environ.get('WORLD_SIZE', '1')) > 1 \
            or len(cfg.get('gpu_ids') or [0]) > 1:
        raise NotImplementedError(
            'train_detector: training on more than one device is data '
            'parallel, not ported yet (ROADMAP.md §1 item 4)')
    log_cfg = cfg.get('log_config') or {}
    if any(h.get('type') == 'TensorboardLoggerHook'
           for h in log_cfg.get('hooks', [])):
        raise NotImplementedError(
            'train_detector: TensorboardLoggerHook is not ported yet '
            '(ROADMAP.md §1 item 1, what the training run still lacks)')
    ckpt_cfg = cfg.get('checkpoint_config') or {}
    if ckpt_cfg.get('backend', 'pickle') != 'pickle' \
            or ckpt_cfg.get('async_save', False):
        raise NotImplementedError(
            'train_detector: checkpoints are .pth files (torch.save of the '
            "mmcv layout); checkpoint_config backend='orbax' and "
            'async_save=True are not ported')


def _append_json_log(work_dir, entry):
    """mmcv-style json-lines training log (ref: mmcv TextLoggerHook json
    output)."""
    with open(os.path.join(work_dir, 'train.log.json'), 'a') as f:
        f.write(json.dumps(entry) + '\n')


def _run_validation(model, val_loader, val_dataset, eval_cfg, dtype):
    """EvalHook (ref: core/evaluation/eval_hooks.py:7-75)."""
    results = single_device_test(model, val_loader, show_progress=False,
                                 dtype=dtype)
    kwargs = {k: v for k, v in eval_cfg.items()
              if k not in ('interval', 'metric')}
    return val_dataset.evaluate(results, metric=eval_cfg.get('metric',
                                                             'bbox'),
                                **kwargs)


def train_detector(model, dataset, cfg, validate=False, logger=None,
                   device='cuda', dtype=torch.float32):
    """Run the training loop of ``cfg`` on one device.

    Args:
        model: the detector built with the config's ``train_cfg``, holding
            its starting weights (e.g. from ``layers.init_weights``).
        dataset: the training set (``data.train``).
        cfg: the :class:`Config`; reads ``data``, ``optimizer``,
            ``optimizer_config.grad_clip``, ``lr_config``, ``total_epochs``,
            ``seed``, ``work_dir``, ``load_from``, ``resume_from``,
            ``log_config``, ``checkpoint_config``, ``evaluation`` and the
            model's ``pretrained`` and ``frozen_stages``.
        validate: evaluate ``data.val`` every ``evaluation.interval``
            epochs.
        logger: a ``logging.Logger`` (default: ``print``).
        device: ``'cuda'`` (default), which raises where there is no card,
            or ``'cpu'`` for the plain PyTorch path.
        dtype: the images' dtype on the device (f32, or bf16 on the card).
    Returns:
        The log entries, as written to ``work_dir/train.log.json``.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('train_detector: no CUDA device (pass '
                           'device="cpu" to run the plain PyTorch path)')
    _check_supported(cfg)
    log = logger.info if logger is not None else print
    cfg_dict = cfg.todict()
    data_cfg = cfg_dict['data']
    seed = cfg.get('seed') or 0
    workers = data_cfg.get('workers_per_gpu', 2)
    loader = build_dataloader(dataset, data_cfg.get('samples_per_gpu', 2),
                              workers, shuffle=True, seed=seed)
    eval_cfg = dict(cfg_dict.get('evaluation') or {})
    val_loader = None
    if validate and data_cfg.get('val'):
        val_dataset = build_dataset(data_cfg['val'], dict(test_mode=True))
        val_loader = build_dataloader(val_dataset, 1, workers, shuffle=False)
    iters_per_epoch = len(loader)
    total_epochs = cfg.get('total_epochs', 12)

    pretrained = cfg_dict['model'].get('pretrained')
    if pretrained and not cfg.get('load_from') and not cfg.get('resume_from'):
        load_pretrained_backbone(pretrained, model, log)
    if cfg.get('load_from'):
        model.load_state_dict(load_checkpoint(cfg['load_from'])[0])
    model.to(device)
    if device.type == 'cuda':
        model.to(memory_format=torch.channels_last)

    opt_cfg = dict(cfg_dict['optimizer'])
    sched = build_lr_schedule(cfg_dict.get('lr_config'), opt_cfg['lr'],
                              iters_per_epoch)
    optimizer, scheduler = build_optimizer(
        opt_cfg, sched, model, frozen_prefixes_from_cfg(cfg_dict['model']))
    step = make_train_step(
        model, optimizer, scheduler,
        (cfg_dict.get('optimizer_config') or {}).get('grad_clip'))

    start_epoch = 0
    if cfg.get('resume_from'):
        state, meta, opt_state, sched_state = load_checkpoint(
            cfg['resume_from'])
        if opt_state is None or sched_state is None:
            raise ValueError(
                f"resume_from={cfg['resume_from']!r} holds no optimizer and "
                'scheduler state: resume from a .pth of this training run '
                '(load_from takes weights alone)')
        model.load_state_dict(state)
        optimizer.load_state_dict(opt_state)
        scheduler.load_state_dict(sched_state)
        start_epoch = meta['epoch']
        log(f"resumed from {cfg['resume_from']}, epoch {start_epoch}")

    work_dir = cfg.get('work_dir', './work_dirs/default')
    os.makedirs(work_dir, exist_ok=True)
    log_interval = (cfg_dict.get('log_config') or {}).get('interval', 50)
    ckpt_interval = (cfg_dict.get('checkpoint_config') or {}).get('interval',
                                                                  1)
    history = []
    global_it = start_epoch * iters_per_epoch
    # FSAF's count of the gts each level took, added up over the run on the
    # device and written to gt_assign.txt at each log iteration, as the
    # JAX package's loop does (the reference writes it inside the loss)
    gt_assign_counts = None
    for epoch in range(start_epoch, total_epochs):
        t_epoch = time.time()
        loader.set_epoch(epoch)
        for it, batch in enumerate(loader):
            batch = dict(
                {k: v.to(device) for k, v in batch.items()
                 if k not in ('img', 'img_metas')},
                img=batch['img'].to(device, dtype),
                img_metas=batch['img_metas'])
            log_vars = step(batch, iteration_generator(seed, global_it,
                                                       device))
            global_it += 1
            if 'gt_assign_hist' in log_vars:
                hist = log_vars.pop('gt_assign_hist')
                gt_assign_counts = hist if gt_assign_counts is None \
                    else gt_assign_counts + hist
            if (it + 1) % log_interval == 0:
                scalars = {k: float(v) for k, v in log_vars.items()}
                # the LR of the next iteration, as the JAX package logs it
                scalars['lr'] = float(sched(global_it))
                entry = dict(mode='train', epoch=epoch + 1, iter=it + 1,
                             **scalars)
                history.append(entry)
                _append_json_log(work_dir, entry)
                msg = ' '.join(f'{k}: {v:.4f}' for k, v in scalars.items())
                log(f'Epoch [{epoch + 1}][{it + 1}/{iters_per_epoch}] {msg}')
                if gt_assign_counts is not None:
                    with open(os.path.join(work_dir, 'gt_assign.txt'),
                              'w') as f:
                        f.write(' '.join(str(int(c)) for c in
                                         gt_assign_counts.tolist()) + '\n')
        log(f'Epoch {epoch + 1} done in {time.time() - t_epoch:.1f}s')
        if val_loader is not None \
                and (epoch + 1) % eval_cfg.get('interval', 1) == 0:
            metrics = _run_validation(model, val_loader, val_dataset,
                                      eval_cfg, dtype)
            msg = ' '.join(f'{k}: {v:.4f}' if isinstance(v, float)
                           else f'{k}: {v}' for k, v in metrics.items())
            log(f'Epoch [{epoch + 1}] val: {msg}')
            entry = dict(epoch=epoch + 1, mode='val',
                         **{k: v for k, v in metrics.items()
                            if isinstance(v, (int, float))})
            history.append(entry)
            _append_json_log(work_dir, entry)
        if (epoch + 1) % ckpt_interval == 0:
            path = os.path.join(work_dir, f'epoch_{epoch + 1}.pth')
            save_checkpoint(path, model, optimizer, scheduler, dict(
                epoch=epoch + 1, iter=global_it,
                CLASSES=getattr(dataset, 'CLASSES', None), config=cfg.text))
            latest = os.path.join(work_dir, 'latest.pth')
            try:
                if os.path.lexists(latest):
                    os.remove(latest)
                os.symlink(os.path.basename(path), latest)
            except OSError:
                pass
    return history
