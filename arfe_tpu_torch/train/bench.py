"""The bench's training set-up, and one training step on the card against
the CPU.

``chip_smoke.py``, ``tools/profile_train.py`` and the ``gpu``-marked tests
take their batch, their trainer and their card-against-CPU comparison from
here:

- :func:`synthetic_batch`: the bench's batch (``bench.py:170-188``), with
  its random 28 x 28 gt mask crops for Mask R-CNN;
- :func:`build_trainer`: the flagship with its ``train_cfg`` and the bench's
  SGD schedule (``bench.py:163-168``);
- :func:`compare_with_cpu`: the losses and gradients of one f32 step of a
  model on the card against the same weights on the CPU (plain path), with
  the same sampling priorities.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .optimizer import (build_lr_schedule, build_optimizer,
                        frozen_prefixes_from_cfg)
from .train_step import parse_losses

_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'configs')
FLAGSHIP_CFG = os.path.join(_CONFIGS, '_base_', 'models',
                            'faster_rcnn_r50_arfpn.py')
#: the AR-RFF flagship (config #4) and the "+fac" detector
ARFE_CFGS = {name: os.path.join(_CONFIGS, 'arfe',
                                f'faster_rcnn_r50_arfpn_{name}_1x_coco.py')
             for name in ('arrff', 'fac')}
#: Mask R-CNN R50 + AR-FPN (config #5a)
MASK_CFG = os.path.join(_CONFIGS, 'arfe', 'mask_rcnn_r50_arfpn_1x_coco.py')
#: Cascade R-CNN R50 + AR-FPN (config #5b) and RetinaNet R50 + AR-FPN
#: (config #2)
CASCADE_CFG = os.path.join(_CONFIGS, 'arfe',
                           'cascade_rcnn_r50_arfpn_1x_coco.py')
RETINA_CFG = os.path.join(_CONFIGS, 'arfe', 'retinanet_r50_arfpn_1x_coco.py')
H, W = 800, 1344             # the bench's padded image (bench.py:28)
IMG_SHAPE = (800.0, 1333.0)  # its content shape (bench.py:90)
BATCH_KEYS = ('img', 'img_shape', 'gt_bboxes', 'gt_valid', 'gt_labels')

# card against CPU: each loss within LOSS_RTOL + 4x the CPU's own spread
# (one thread against all), relative; each parameter's largest gradient
# difference within GRAD_RTOL of its largest |g|. At random weights the step
# is sensitive to rounding (the unscaled AR-FPN attention logits reach
# hundreds): two summation orders of the same f32 step differ by up to ~1e-2
# of a parameter's largest gradient. A wrong kernel differs by O(1). After a
# few steps at full width some parameters' spread can pass the limit, so
# compare seeded weights, which give the same reading in every run.
LOSS_RTOL = 1e-4
GRAD_RTOL = 5e-2


def synthetic_batch(b, h=H, w=W, img_shape=IMG_SHAPE, dtype=torch.bfloat16,
                    seed=0, g=16, device='cuda', masks=False):
    """The bench's training batch (``bench.py:170-188``): 8 gt boxes of
    30-80 px per image, padded to ``g``, labels 0-79, random (h, w) images
    whose content is ``img_shape``, and with ``masks`` random binary 28 x 28
    ``gt_mask_crops``; drawn from a numpy seed."""
    r = np.random.RandomState(seed)
    gt = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int64)
    for i in range(b):
        xy = r.uniform(0, [w - 80, h - 80], (8, 2))
        gt[i, :8] = np.concatenate([xy, xy + r.uniform(30, 80, (8, 2))], -1)
        valid[i, :8] = True
        labels[i, :8] = r.randint(0, 80, 8)
    img = torch.from_numpy((r.randn(b, h, w, 3) * 0.2).astype(np.float32))
    batch = dict(img=img.to(dtype), img_shape=torch.tensor([img_shape] * b),
                 gt_bboxes=torch.from_numpy(gt),
                 gt_valid=torch.from_numpy(valid),
                 gt_labels=torch.from_numpy(labels))
    if masks:
        batch['gt_mask_crops'] = torch.from_numpy(
            (r.rand(b, g, 28, 28) > 0.5).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def build_trainer(cfg=FLAGSHIP_CFG, device='cuda', seed=1):
    """``(model, optimizer, scheduler, frozen_prefixes)``: the detector of
    ``cfg`` with its ``train_cfg`` and seeded random weights, its NonLocal
    ``conv_out`` (zero at init) made nonzero so the attention's gradient
    path is live, and the bench's optimizer: SGD lr 0.02, momentum 0.9,
    weight decay 1e-4, linear warmup over 500 iterations from ratio 0.001,
    the config's ``frozen_stages``."""
    from ..apis import init_detector
    model = init_detector(cfg, device=device, train=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w = model.neck[1].refine.conv_out.conv.weight
        w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
    sched = build_lr_schedule(
        dict(policy='step', warmup='linear', warmup_iters=500,
             warmup_ratio=0.001, step=[8, 11]), 0.02, 1000)
    frozen = frozen_prefixes_from_cfg(model.cfg.todict()['model'])
    opt, scheduler = build_optimizer(
        dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=0.0001), sched,
        model, frozen)
    return model, opt, scheduler, frozen


def num_anchors(model, h, w):
    """Anchors of the dense head's table for an (h, w) image."""
    gen = model.dense_head.anchor_generator
    return sum(n * -(-h // s[1]) * -(-w // s[0])
               for s, n in zip(gen.strides, gen.num_base_anchors))


def sampled_candidates(model, num_gts, h, w):
    """Each sampler that draws, with the candidates it draws among: the
    dense head's over its anchors (none for a pseudo sampler), then each
    RoI head stage's over its gts (when it adds them) and proposals, or a
    cascade's later stage's over its gts and the previous stage's
    samples."""
    head = model.dense_head
    out = [(head.sampler, num_anchors(model, h, w))] if head.sampling \
        else []
    if model.roi_samplers:
        n = model.train_cfg['rpn_proposal']['nms_post']
        for sampler in model.roi_samplers:
            out.append((sampler, n + num_gts * sampler.add_gt_as_proposals))
            n = getattr(sampler, 'num', out[-1][1])
    return out


def fix_priorities(model, num_gts, h, w, seed=5):
    """The same sampling priorities on every model: uniform draws from a
    seeded CPU generator for each sampler's candidates
    (:func:`sampled_candidates`), ``inf`` where a box is not a candidate."""
    gen = torch.Generator().manual_seed(seed)
    for sampler, n in sampled_candidates(model, num_gts, h, w):
        pos, neg = (torch.rand(n, generator=gen) for _ in range(2))

        def fixed(p):
            return lambda g, cand, ctx: torch.where(
                cand, p.to(cand.device), float('inf'))
        sampler._pos_priority = fixed(pos)
        sampler._neg_priority = fixed(neg)


def loss_and_grads(model, batch, seed=5):
    """Losses and parameter gradients (on the CPU) of one ``forward_train``
    + backward on the model's device, with the fixed sampling priorities."""
    dev = next(model.parameters()).device
    _, h, w, _ = batch['img'].shape
    fix_priorities(model, batch['gt_bboxes'].shape[1], h, w, seed)
    model.zero_grad(set_to_none=True)
    crops = batch.get('gt_mask_crops')
    total, logs = parse_losses(model.forward_train(
        *[batch[k].to(dev) for k in BATCH_KEYS], None,
        gt_mask_crops=None if crops is None else crops.to(dev)))
    total.backward()
    return ({k: float(v.detach()) for k, v in logs.items()},
            {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters() if p.grad is not None})


def differences(a, b):
    """Each loss's relative difference, and the largest gradient difference
    of a parameter over its largest |g| (plus 1e-6 of the largest |g| of
    all, for gradients that are 0 in exact arithmetic, such as the NonLocal
    ``phi`` bias, which shifts each row's logits by a constant), with that
    parameter's name."""
    (la, ga), (lb, gb) = a, b
    losses = {k: abs(la[k] - lb[k]) / max(abs(la[k]), 1e-12) for k in la}
    floor = 1e-6 * max(g.abs().max().item() for g in ga.values())
    grads = max(((ga[k] - gb[k]).abs().max().item()
                 / (ga[k].abs().max().item() + floor), k) for k in ga)
    return losses, grads


def compare_with_cpu(model, cpu, batch, seed=5):
    """One f32 ``forward_train`` + backward of ``batch`` on ``model`` (the
    card) and on ``cpu`` (the same weights, plain path), and once more on
    the CPU with one thread, all with the same sampling priorities.

    Returns a dict: ``loss_err`` and ``loss_spread`` (per loss, relative;
    card against CPU, and the CPU with one thread against all), ``grad_err``
    and ``grad_spread`` (``(largest relative difference, parameter)``),
    ``params`` (how many parameters have a gradient), ``same_params``,
    ``cpu_s``, ``threads``, ``ok`` under ``LOSS_RTOL`` / ``GRAD_RTOL``, and
    ``cpu``, the CPU's :func:`loss_and_grads`.
    """
    t0 = time.time()
    want = loss_and_grads(cpu, batch, seed)
    cpu_s = time.time() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alt = loss_and_grads(cpu, batch, seed)
    finally:
        torch.set_num_threads(threads)
    got = loss_and_grads(model, batch, seed)
    loss_spread, grad_spread = differences(want, alt)
    loss_err, grad_err = differences(want, got)
    same = sorted(got[1]) == sorted(want[1])
    ok = (all(loss_err[k] <= LOSS_RTOL + 4 * loss_spread[k]
              for k in loss_err)
          and grad_err[0] <= GRAD_RTOL and same and len(want[1]) > 100)
    return dict(loss_err=loss_err, loss_spread=loss_spread,
                grad_err=grad_err, grad_spread=grad_spread,
                params=len(want[1]), same_params=same, cpu_s=cpu_s,
                threads=threads, ok=ok, cpu=want)
