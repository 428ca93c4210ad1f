"""Dataset and loader construction (counterpart of
``arfe_tpu/data/builder.py``; ref: mmdet/datasets/builder.py:49-135 and
samplers/group_sampler.py).

The loader is a ``torch.utils.data.DataLoader`` driven by
:class:`GroupBatchSampler`. Its collate pads each batch to the multiple of
32 above the batch's largest image, as the reference does; the JAX
package's static pad buckets, which bound XLA's recompilation, and its
thread pool with a prefetch queue are not ported. Worker processes start by
``spawn``.
"""
from __future__ import annotations

import multiprocessing

import numpy as np
import torch
from torch.utils.data import DataLoader

from ..registry import DATASETS, build_from_cfg

PAD_DIVISOR = 32
MAX_GT = 100
#: side of the fixed gt mask crops (``BitmapMasks.to_fixed_crops``)
MASK_CROP_SIZE = 112


def build_dataset(cfg, default_args=None):
    """(ref: datasets/builder.py:49-66). The dataset wrappers (concat,
    repeat, class-balanced) are not ported yet (ROADMAP §1)."""
    if isinstance(cfg, (list, tuple)) or cfg['type'] in (
            'ConcatDataset', 'RepeatDataset', 'ClassBalancedDataset'):
        raise NotImplementedError('build_dataset: dataset wrappers are not '
                                  'ported yet')
    return build_from_cfg(cfg, DATASETS, default_args)


class GroupBatchSampler:
    """Aspect-ratio-grouped batch index sampler (ref:
    samplers/group_sampler.py:10-49; ``arfe_tpu/data/builder.py:38-77``):
    batches come from one group; with ``shuffle`` each group's indices are
    shuffled per epoch (from ``seed + epoch``) and padded to a multiple of
    the batch size, and the batches are shuffled; without it the groups go
    in order and a group's last batch may be short."""

    def __init__(self, flags, samples_per_batch, shuffle=True, seed=0):
        self.flags = np.asarray(flags)
        self.bs = samples_per_batch
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        batches = []
        for flag in np.unique(self.flags):
            inds = np.where(self.flags == flag)[0]
            if self.shuffle:
                inds = inds[rng.permutation(len(inds))]
            pad = (-len(inds)) % self.bs
            if pad and self.shuffle:
                inds = np.concatenate([inds, inds[:pad]])
            for i in range(0, len(inds) - self.bs + 1, self.bs):
                batches.append(inds[i:i + self.bs])
            if not self.shuffle and len(inds) % self.bs:
                batches.append(inds[len(inds) - len(inds) % self.bs:])
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return iter(batches)

    def __len__(self):
        return sum(-(-int((self.flags == flag).sum()) // self.bs)
                   for flag in np.unique(self.flags))


class _EpochBatches:
    """The sampler's batches as ``(epoch, index)`` pairs, so that a worker
    process, which does not see the sampler, knows each sample's epoch."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __iter__(self):
        epoch = self.sampler.epoch
        return ([(epoch, int(i)) for i in batch] for batch in self.sampler)

    def __len__(self):
        return len(self.sampler)


class _SeededSamples(torch.utils.data.Dataset):
    """``dataset[index]`` for the key ``(epoch, index)``, with numpy's global
    generator seeded from ``(seed, epoch, index)`` while the pipeline runs:
    its random draws (``RandomFlip``, the ranges of ``Resize``) depend on
    nothing else, in a worker or in the calling process, in a resumed run
    as in an uninterrupted one. The calling process's generator state is
    put back afterwards."""

    def __init__(self, dataset, seed):
        self.dataset = dataset
        self.seed = seed

    def __getitem__(self, key):
        epoch, index = key
        state = np.random.get_state()
        np.random.seed([self.seed, epoch, index])
        try:
            return self.dataset[index]
        finally:
            np.random.set_state(state)


class DetLoader(DataLoader):
    """A ``DataLoader`` over a :class:`GroupBatchSampler`;
    :meth:`set_epoch` picks the epoch whose order and draws the next pass
    gives."""

    def set_epoch(self, epoch):
        self.batch_sampler.sampler.epoch = epoch


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


def collate_train(samples, max_gt=MAX_GT, mask_crop_size=MASK_CROP_SIZE):
    """:func:`collate_test`'s batch plus the ground truth padded to
    ``max_gt`` boxes (the first ``max_gt`` of an image that has more):
    ``gt_bboxes`` (B, G, 4) f32, ``gt_valid`` (B, G) bool and ``gt_labels``
    (B, G) int64; where the samples have ``gt_masks``, also
    ``gt_mask_crops`` (B, G, cs, cs) f32, each gt's mask cut to its box and
    resized (``BitmapMasks.to_fixed_crops``), zero for padding. Equals
    ``arfe_tpu.data.builder.collate_detection(samples,
    static_shapes=None)``, as tensors."""
    batch = collate_test(samples)
    b = len(samples)
    gt_bboxes = np.zeros((b, max_gt, 4), np.float32)
    gt_valid = np.zeros((b, max_gt), bool)
    gt_labels = np.zeros((b, max_gt), np.int64)
    for i, s in enumerate(samples):
        n = min(len(s['gt_bboxes']), max_gt)
        gt_bboxes[i, :n] = s['gt_bboxes'][:n]
        gt_valid[i, :n] = True
        gt_labels[i, :n] = s['gt_labels'][:n]
    batch.update(gt_bboxes=torch.from_numpy(gt_bboxes),
                 gt_valid=torch.from_numpy(gt_valid),
                 gt_labels=torch.from_numpy(gt_labels))
    if any('gt_masks' in s for s in samples):
        crops = np.zeros((b, max_gt, mask_crop_size, mask_crop_size),
                         np.float32)
        for i, s in enumerate(samples):
            masks = s.get('gt_masks')
            n = min(len(masks) if masks is not None else 0,
                    len(s['gt_bboxes']), max_gt)
            if n:
                crops[i, :n] = masks[list(range(n))].to_fixed_crops(
                    s['gt_bboxes'][:n], mask_crop_size)
        batch['gt_mask_crops'] = torch.from_numpy(crops)
    return batch


def build_dataloader(dataset, samples_per_gpu=2, workers_per_gpu=2,
                     shuffle=True, seed=0):
    """A :class:`DetLoader` of ``samples_per_gpu`` images a batch, read and
    transformed in ``workers_per_gpu`` worker processes (0: in the calling
    process).

    A training set (``dataset.test_mode`` false) gives
    :func:`collate_train`'s batches in aspect-ratio groups, shuffled by
    ``seed`` and the epoch of :meth:`DetLoader.set_epoch` (``shuffle``);
    its workers persist from one epoch to the next. A test set gives
    :func:`collate_test`'s batches in the dataset's order, whatever
    ``shuffle`` says, and its workers last one pass.
    """
    test_mode = getattr(dataset, 'test_mode', False)
    flags = getattr(dataset, 'flag', np.zeros(len(dataset), np.uint8))
    sampler = GroupBatchSampler(flags, samples_per_gpu,
                                shuffle=shuffle and not test_mode, seed=seed)
    workers = int(workers_per_gpu)
    return DetLoader(
        _SeededSamples(dataset, seed), batch_sampler=_EpochBatches(sampler),
        num_workers=workers,
        collate_fn=collate_test if test_mode else collate_train,
        multiprocessing_context=(multiprocessing.get_context('spawn')
                                 if workers > 0 else None),
        persistent_workers=workers > 0 and not test_mode)
