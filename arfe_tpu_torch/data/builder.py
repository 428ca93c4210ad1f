"""Dataset and test-loader construction (counterpart of
``arfe_tpu/data/builder.py``; ref: mmdet/datasets/builder.py:49-135).

The loader is a ``torch.utils.data.DataLoader``. Its collate pads each
batch to the multiple of 32 above the batch's largest image, as the
reference does; the JAX package's static pad buckets, which bound XLA's
recompilation, are not ported. Worker processes start by ``spawn``.
"""
from __future__ import annotations

import multiprocessing

import numpy as np
import torch
from torch.utils.data import DataLoader, SequentialSampler

from ..registry import DATASETS, build_from_cfg

PAD_DIVISOR = 32


def build_dataset(cfg, default_args=None):
    """(ref: datasets/builder.py:49-66). The dataset wrappers (concat,
    repeat, class-balanced) come with the training run (ROADMAP §1)."""
    if isinstance(cfg, (list, tuple)) or cfg['type'] in (
            'ConcatDataset', 'RepeatDataset', 'ClassBalancedDataset'):
        raise NotImplementedError('build_dataset: dataset wrappers are not '
                                  'ported yet')
    return build_from_cfg(cfg, DATASETS, default_args)


def collate_test(samples):
    """Stack test-pipeline outputs into a batch: ``img`` (B, H, W, 3) f32,
    zero-padded at the bottom and right to the multiple of 32 above the
    batch's largest image; ``img_shape`` (B, 2) f32 (h, w) of each resized
    image; ``scale_factor`` (B, 4) f32; ``img_metas``, the list of meta
    dicts. Equals ``arfe_tpu.data.builder.collate_detection(samples,
    static_shapes=None, test_mode=True)``, as tensors."""
    # MultiScaleFlipAug at one scale gives one-element lists
    samples = [{k: (v[0] if isinstance(v, list) and len(v) == 1 else v)
                for k, v in s.items()} for s in samples]
    metas = [s['img_metas'] for s in samples]
    imgs = [s['img'] for s in samples]
    h = -(-max(i.shape[0] for i in imgs) // PAD_DIVISOR) * PAD_DIVISOR
    w = -(-max(i.shape[1] for i in imgs) // PAD_DIVISOR) * PAD_DIVISOR
    batch = np.zeros((len(imgs), h, w, imgs[0].shape[2]), np.float32)
    for out, img in zip(batch, imgs):
        out[:img.shape[0], :img.shape[1]] = img
    scale = [np.ones(4, np.float32) if m.get('scale_factor') is None
             else np.asarray(m['scale_factor'], np.float32).reshape(-1)[:4]
             for m in metas]
    return {
        'img': torch.from_numpy(batch),
        'img_shape': torch.tensor([m['img_shape'][:2] for m in metas],
                                  dtype=torch.float32),
        'scale_factor': torch.from_numpy(np.stack(scale)),
        'img_metas': metas,
    }


def build_dataloader(dataset, samples_per_gpu=1, workers_per_gpu=2):
    """A test loader: the dataset in order, ``samples_per_gpu`` images a
    batch, read and transformed in ``workers_per_gpu`` worker processes (0:
    in the calling process). The training sampler (shuffled aspect-ratio
    groups) comes with the training run (ROADMAP §1)."""
    workers = int(workers_per_gpu)
    return DataLoader(
        dataset, batch_size=samples_per_gpu,
        sampler=SequentialSampler(dataset), num_workers=workers,
        collate_fn=collate_test,
        multiprocessing_context=(multiprocessing.get_context('spawn')
                                 if workers > 0 else None))
