"""Base dataset (counterpart of ``arfe_tpu/data/custom.py``; ref:
mmdet/datasets/custom.py:20-230).

Annotation format: a list of dicts with filename/width/height + ann
(bboxes, labels, bboxes_ignore, labels_ignore). The aspect-ratio ``flag``
groups training batches (ref: custom.py:123-134).
"""
from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np

from ..registry import DATASETS
from .pipelines import Compose


@DATASETS.register_module()
class CustomDataset:
    CLASSES = None

    def __init__(self, ann_file, pipeline, classes=None, data_root=None,
                 img_prefix='', seg_prefix=None, proposal_file=None,
                 test_mode=False, filter_empty_gt=True):
        self.ann_file = ann_file
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.proposal_file = proposal_file
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = self.get_classes(classes)
        if data_root is not None:
            if not osp.isabs(self.ann_file):
                self.ann_file = osp.join(data_root, self.ann_file)
            if not (self.img_prefix and osp.isabs(self.img_prefix)):
                self.img_prefix = osp.join(data_root, self.img_prefix)
        self.data_infos = self.load_annotations(self.ann_file)
        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            self._set_group_flag()
        else:
            self.flag = np.zeros(len(self.data_infos), dtype=np.uint8)
        self.pipeline = Compose(pipeline)

    @classmethod
    def get_classes(cls, classes=None):
        if classes is None:
            return cls.CLASSES
        if isinstance(classes, str):
            with open(classes) as f:
                return [line.strip() for line in f if line.strip()]
        return list(classes)

    def load_annotations(self, ann_file):
        if ann_file.endswith('.json'):
            with open(ann_file) as f:
                return json.load(f)
        with open(ann_file, 'rb') as f:
            return pickle.load(f)

    def get_ann_info(self, idx):
        return self.data_infos[idx]['ann']

    def _filter_imgs(self, min_size=32):
        valid_inds = []
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and len(
                    self.get_ann_info(i).get('bboxes', [])) == 0:
                continue
            if min(info['width'], info['height']) >= min_size:
                valid_inds.append(i)
        return valid_inds

    def _set_group_flag(self):
        """Group by aspect ratio (ref: custom.py:123-134)."""
        self.flag = np.array([info['width'] / info['height'] > 1
                              for info in self.data_infos], dtype=np.uint8)

    def __len__(self):
        return len(self.data_infos)

    def pre_pipeline(self, results):
        results['img_prefix'] = self.img_prefix
        results['seg_prefix'] = self.seg_prefix
        results['proposal_file'] = self.proposal_file
        results['bbox_fields'] = []
        results['mask_fields'] = []
        return results

    def prepare_train_img(self, idx):
        results = dict(img_info=self.data_infos[idx],
                       ann_info=self.get_ann_info(idx))
        return self.pipeline(self.pre_pipeline(results))

    def prepare_test_img(self, idx):
        results = dict(img_info=self.data_infos[idx])
        return self.pipeline(self.pre_pipeline(results))

    def _rand_another(self, idx):
        pool = np.where(self.flag == self.flag[idx])[0]
        return int(np.random.choice(pool))

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is not None:
                return data
            idx = self._rand_another(idx)

    def evaluate(self, results, metric='mAP', **kwargs):
        """The VOC protocol (ref: custom.py:166-230): its ``mAP`` and
        ``recall`` wait for ``mean_ap`` and ``recall`` (ROADMAP §1)."""
        raise NotImplementedError(
            f'CustomDataset.evaluate({metric!r}): the VOC mean_ap and recall '
            'are not ported yet')
