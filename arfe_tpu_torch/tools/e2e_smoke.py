"""End-to-end smoke of the port's CLIs: train -> resume -> test --eval bbox
on a synthetic tiny COCO set (the port's copy of ``tools/e2e_smoke.py``).

    python -m arfe_tpu_torch.tools.e2e_smoke [--root DIR] [--epochs N]
        [--device cuda|cpu]

Writes 8 PNGs of 128x160 with 3-6 boxes each (``data.synthetic.
write_box_set``, one category, 'box') and the JAX tool's tiny config with
the AR-FPN neck and the AR-RFF head (``MultiRoIsBBoxHead``), so that the
attention, the RoIAlign and its backward all run; then, through the
``train`` and ``test`` CLIs' ``main``: trains ``--epochs`` epochs (the
gradient clip, the warm-up and a step of the LR), resumes the run from
``epoch_1.pth`` and trains its last epochs again, and evaluates
``latest.pth``. Prints one JSON line ``{"ok": ..., "stages": ...}`` and
exits 0 only if every stage gave a finite loss or mAP. ``--device``
defaults to the card; a few seconds on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys

from ..data import synthetic
from . import test as test_cli
from . import train as train_cli

CFG_TMPL = """
dataset_type = 'CocoDataset'
classes = ('box',)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(160, 128), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels']),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(160, 128), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='RandomFlip'),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='Pad', size_divisor=32),
             dict(type='ImageToTensor', keys=['img']),
             dict(type='Collect', keys=['img']),
         ])
]
data = dict(
    samples_per_gpu=2, workers_per_gpu=0,
    train=dict(type=dataset_type, classes=classes,
               ann_file='{root}/ann.json',
               img_prefix='{root}/imgs/', pipeline=train_pipeline),
    val=dict(type=dataset_type, classes=classes,
             ann_file='{root}/ann.json',
             img_prefix='{root}/imgs/', pipeline=test_pipeline),
    test=dict(type=dataset_type, classes=classes,
              ann_file='{root}/ann.json',
              img_prefix='{root}/imgs/', pipeline=test_pipeline))
model = dict(
    type='FasterRCNN',
    backbone=dict(type='ResNet', depth=18, num_stages=4,
                  out_indices=(0, 1, 2, 3), frozen_stages=1,
                  norm_cfg=dict(type='BN', requires_grad=True),
                  norm_eval=True, style='pytorch'),
    neck=[dict(type='FPN', in_channels=[64, 128, 256, 512],
               out_channels=64, num_outs=5),
          dict(type='WFPNDualSpatial', in_channels=64, num_levels=5)],
    rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64,
                  anchor_generator=dict(type='AnchorGenerator', scales=[4],
                                        ratios=[0.5, 1.0, 2.0],
                                        strides=[4, 8, 16, 32, 64]),
                  bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                                  target_means=[.0, .0, .0, .0],
                                  target_stds=[1.0, 1.0, 1.0, 1.0]),
                  loss_cls=dict(type='CrossEntropyLoss',
                                use_sigmoid=True, loss_weight=1.0),
                  loss_bbox=dict(type='L1Loss', loss_weight=1.0)),
    roi_head=dict(
        type='StandardRoIHead',
        bbox_roi_extractor=dict(
            type='SingleRoIExtractor',
            roi_layer=dict(type='RoIAlign', out_size=7, sample_num=2),
            out_channels=64, featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(type='MultiRoIsBBoxHead', num_shared_fcs=2,
                       in_channels=64, fc_out_channels=128, roi_feat_size=7,
                       num_classes=1,
                       bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                                       target_means=[0., 0., 0., 0.],
                                       target_stds=[0.1, 0.1, 0.2, 0.2]),
                       reg_class_agnostic=False,
                       loss_cls=dict(type='CrossEntropyLoss',
                                     use_sigmoid=False, loss_weight=1.0),
                       loss_bbox=dict(type='L1Loss', loss_weight=1.0))))
train_cfg = dict(
    rpn=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.7,
                           neg_iou_thr=0.3, min_pos_iou=0.3,
                           match_low_quality=True, ignore_iof_thr=-1),
             sampler=dict(type='RandomSampler', num=64, pos_fraction=0.5,
                          neg_pos_ub=-1, add_gt_as_proposals=False),
             allowed_border=-1, pos_weight=-1, debug=False),
    rpn_proposal=dict(nms_pre=200, nms_post=100, max_num=100,
                      nms_thr=0.7, min_bbox_size=0),
    rcnn=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                            neg_iou_thr=0.5, min_pos_iou=0.5,
                            match_low_quality=False, ignore_iof_thr=-1),
              sampler=dict(type='RandomSampler', num=64, pos_fraction=0.25,
                           neg_pos_ub=-1, add_gt_as_proposals=True),
              pos_weight=-1, debug=False))
test_cfg = dict(
    rpn=dict(nms_pre=100, nms_post=50, max_num=50, nms_thr=0.7,
             min_bbox_size=0),
    rcnn=dict(score_thr=0.05, nms=dict(type='nms', iou_thr=0.5),
              max_per_img=20))
optimizer = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=0.0001)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy='step', warmup='linear', warmup_iters=5,
                 warmup_ratio=0.001, step=[2])
checkpoint_config = dict(interval=1)
log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
total_epochs = {epochs}
evaluation = dict(interval={epochs}, metric='bbox')
dist_params = dict(backend='nccl')
log_level = 'INFO'
load_from = None
resume_from = None
workflow = [('train', 1)]
"""

SIZES = [(128, 160)] * 8


def write_set(root, epochs):
    """The box set under ``root`` and its config; returns the config's
    path."""
    synthetic.write_box_set(root, SIZES, (3, 6), seed=0,
                            categories=[dict(id=1, name='box')])
    path = os.path.join(root, 'cfg.py')
    with open(path, 'w') as f:
        f.write(CFG_TMPL.replace('{root}', root).replace('{epochs}',
                                                         str(epochs)))
    return path


def _losses(history):
    return [e['loss'] for e in history if e['mode'] == 'train']


def run(root, epochs=2, device='cuda'):
    """Train, resume, test; returns the JSON line's dict."""
    root = os.path.abspath(root)
    cfg = write_set(root, epochs)
    work = os.path.join(root, 'work')
    shutil.rmtree(work, ignore_errors=True)
    common = [cfg, '--work-dir', work, '--seed', '0', '--no-validate',
              '--device', device]
    out = {'ok': False, 'stages': {}}
    stages = [
        ('train', lambda: _losses(train_cli.main(common))),
        ('resume', lambda: _losses(train_cli.main(
            common + ['--resume-from', os.path.join(work, 'epoch_1.pth')]))),
        ('test', lambda: [test_cli.main([
            cfg, os.path.join(work, 'latest.pth'), '--eval', 'bbox',
            '--device', device])['bbox_mAP']]),
    ]
    for name, stage in stages:
        values = stage()
        key = 'bbox_mAP' if name == 'test' else 'last_loss'
        out['stages'][name] = {'n': len(values),
                               key: values[-1] if values else None}
        if not values or not math.isfinite(values[-1]):
            out['error'] = f'{name} gave no finite value'
            return out
    out['ok'] = True
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default='build/e2e_smoke')
    ap.add_argument('--epochs', type=int, default=2)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    out = run(args.root, args.epochs, args.device)
    print(json.dumps(out), flush=True)
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
