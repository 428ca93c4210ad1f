"""Dataset wrappers (counterpart of ``arfe_tpu/data/dataset_wrappers.py:
14-101``; ref: mmdet/datasets/dataset_wrappers.py:11-180): several datasets
read as one, a dataset repeated, and a dataset whose images with rare
classes repeat. Each keeps its datasets' aspect-ratio ``flag`` for
``GroupBatchSampler``."""
from __future__ import annotations

import bisect
import math
from collections import defaultdict

import numpy as np

from ..registry import DATASETS


@DATASETS.register_module()
class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        if all(hasattr(d, 'flag') for d in self.datasets):
            self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        return ds, idx if ds == 0 else idx - self.cumulative_sizes[ds - 1]

    def __getitem__(self, idx):
        ds, local = self._locate(idx)
        return self.datasets[ds][local]

    def get_ann_info(self, idx):
        ds, local = self._locate(idx)
        return self.datasets[ds].get_ann_info(local)


@DATASETS.register_module()
class RepeatDataset:
    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        if hasattr(dataset, 'flag'):
            self.flag = np.tile(dataset.flag, times)
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx % self._ori_len)


@DATASETS.register_module()
class ClassBalancedDataset:
    """Each image repeated ``ceil`` of its repeat factor times: the largest,
    over its classes, of max(1, sqrt(``oversample_thr`` / the share of
    images that hold the class))."""

    def __init__(self, dataset, oversample_thr):
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.CLASSES = dataset.CLASSES
        self.repeat_factors = self._get_repeat_factors(dataset,
                                                       oversample_thr)
        self.repeat_indices = [idx for idx, rf in
                               enumerate(self.repeat_factors)
                               for _ in range(math.ceil(rf))]
        if hasattr(dataset, 'flag'):
            self.flag = np.asarray([dataset.flag[i]
                                    for i in self.repeat_indices],
                                   dtype=np.uint8)

    @staticmethod
    def _get_repeat_factors(dataset, repeat_thr):
        n = len(dataset)
        img_cats = [set(dataset.get_ann_info(i)['labels'].tolist())
                    for i in range(n)]
        category_freq = defaultdict(float)
        for cats in img_cats:
            for c in cats:
                category_freq[c] += 1
        category_repeat = {c: max(1.0, math.sqrt(repeat_thr / (f / n)))
                           for c, f in category_freq.items()}
        return [max([category_repeat[c] for c in cats], default=1.0)
                for cats in img_cats]

    def __len__(self):
        return len(self.repeat_indices)

    def __getitem__(self, idx):
        return self.dataset[self.repeat_indices[idx]]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(self.repeat_indices[idx])
