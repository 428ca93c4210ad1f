"""COCO and VisDrone datasets (counterpart of ``arfe_tpu/data/coco.py``;
ref: mmdet/datasets/coco.py:19-430), on the port's own COCO API and
``COCOEvaluator``. The ``bbox`` and ``segm`` metrics (masks as uncompressed
RLE: pycocotools is not installed), and the proposals' average recall
(``proposal`` and ``proposal_fast``, the same computation here as in the
JAX package).
"""
from __future__ import annotations

import json

import numpy as np

from ..core.evaluation import COCOEvaluator, eval_recalls
from ..core.mask.rle import mask_to_rle
from ..registry import DATASETS
from .coco_api import COCO
from .custom import CustomDataset

STATS = ('AP', 'AP50', 'AP75', 'APs', 'APm', 'APl')
_EMPTY = {'images': [], 'annotations': [], 'categories': []}


@DATASETS.register_module()
class CocoDataset(CustomDataset):
    CLASSES = (
        'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
        'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
        'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog',
        'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
        'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
        'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
        'baseball glove', 'skateboard', 'surfboard', 'tennis racket',
        'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl',
        'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
        'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
        'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop',
        'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
        'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
        'scissors', 'teddy bear', 'hair drier', 'toothbrush')

    def load_annotations(self, ann_file):
        """(ref: coco.py:33-52)."""
        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.getCatIds(catNms=self.CLASSES) \
            if self.CLASSES else self.coco.getCatIds()
        if not self.cat_ids:
            self.cat_ids = self.coco.getCatIds()
        self.cat2label = {cat_id: i for i, cat_id in enumerate(self.cat_ids)}
        self.img_ids = self.coco.getImgIds()
        data_infos = []
        for i in self.img_ids:
            info = self.coco.loadImgs([i])[0]
            info['filename'] = info['file_name']
            data_infos.append(info)
        return data_infos

    def get_ann_info(self, idx):
        img_id = self.data_infos[idx]['id']
        ann_info = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[img_id]))
        return self._parse_ann_info(self.data_infos[idx], ann_info)

    def _filter_imgs(self, min_size=32):
        """(ref: coco.py:78-96)."""
        valid_inds = []
        ids_with_ann = set(a['image_id'] for a in self.coco.anns.values())
        ids_in_cat = set()
        for cat_id in self.cat_ids:
            ids_in_cat |= set(self.coco.cat_img_map[cat_id])
        ids_in_cat &= ids_with_ann
        valid_img_ids = []
        for i, img_info in enumerate(self.data_infos):
            img_id = self.img_ids[i]
            if self.filter_empty_gt and img_id not in ids_in_cat:
                continue
            if min(img_info['width'], img_info['height']) >= min_size:
                valid_inds.append(i)
                valid_img_ids.append(img_id)
        self.img_ids = valid_img_ids
        return valid_inds

    def _parse_ann_info(self, img_info, ann_info):
        """(ref: coco.py:98-162)."""
        gt_bboxes, gt_labels, gt_bboxes_ignore, gt_masks_ann = [], [], [], []
        for ann in ann_info:
            if ann.get('ignore', False):
                continue
            x1, y1, w, h = ann['bbox']
            inter_w = max(0, min(x1 + w, img_info['width']) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info['height']) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann['area'] <= 0 or w < 1 or h < 1:
                continue
            if ann['category_id'] not in self.cat2label:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get('iscrowd', False):
                gt_bboxes_ignore.append(bbox)
            else:
                gt_bboxes.append(bbox)
                gt_labels.append(self.cat2label[ann['category_id']])
                gt_masks_ann.append(ann.get('segmentation'))
        return dict(
            bboxes=np.array(gt_bboxes, dtype=np.float32).reshape(-1, 4),
            labels=np.array(gt_labels, dtype=np.int64),
            bboxes_ignore=np.array(gt_bboxes_ignore,
                                   dtype=np.float32).reshape(-1, 4),
            masks=gt_masks_ann,
            seg_map=img_info['filename'].replace('jpg', 'png'))

    def _det2json(self, results):
        """Per-class (k, 5) arrays of each image (the first of a mask
        model's ``(bbox, segm)`` pair) -> COCO json dicts (ref:
        coco.py:182-227)."""
        json_results = []
        for idx, result in enumerate(results):
            img_id = self.img_ids[idx]
            if isinstance(result, tuple):
                result = result[0]
            for label, bboxes in enumerate(result):
                for bbox in bboxes:
                    x1, y1, x2, y2, score = bbox[:5].tolist()
                    json_results.append(dict(
                        image_id=img_id,
                        bbox=[x1, y1, x2 - x1, y2 - y1],
                        score=float(score),
                        category_id=self.cat_ids[label]))
        return json_results

    def _segm2json(self, results):
        """``(bbox, segm)`` results -> COCO segm json dicts, each mask (a
        binary array or an RLE) as uncompressed RLE with its detection's
        score (ref: coco.py:229-267)."""
        json_results = []
        for idx, result in enumerate(results):
            if not isinstance(result, tuple):
                raise ValueError('segm metric needs (bbox, segm) results')
            img_id = self.img_ids[idx]
            det, seg = result
            for label, bboxes in enumerate(det):
                for bbox, rle in zip(bboxes, seg[label]):
                    if not isinstance(rle, dict):
                        rle = mask_to_rle(np.asarray(rle))
                    json_results.append(dict(
                        image_id=img_id, segmentation=rle,
                        score=float(bbox[4]),
                        category_id=self.cat_ids[label]))
        return json_results

    def results2json(self, results, outfile_prefix=None):
        """(ref: coco.py:229-267)."""
        json_results = self._det2json(results)
        if outfile_prefix is None:
            return json_results
        path = f'{outfile_prefix}.bbox.json'
        with open(path, 'w') as f:
            json.dump(json_results, f)
        return {'bbox': path}

    def evaluate(self, results, metric='bbox', iou_thrs=None,
                 proposal_nums=(100, 300, 1000)):
        """COCO protocol evaluation (ref: coco.py:320-430): for each of
        ``bbox`` and ``segm`` asked for, its six stats ``{m}_mAP``,
        ``{m}_AP50`` ... ``{m}_APl``; ``segm`` needs a mask model's
        ``(bbox, segm)`` results. ``proposal`` or ``proposal_fast`` take
        each image's proposals ((n, 5) with scores, or a list of such
        arrays) and give ``AR@{n}`` for each of ``proposal_nums``: the
        recall averaged over the IoU thresholds 0.5, 0.55 ... 0.95
        (``arfe_tpu/data/coco.py:162-207``)."""
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m not in ('bbox', 'segm', 'proposal', 'proposal_fast'):
                raise KeyError(f'metric {m} is not supported')
        out = {}
        for m in ('bbox', 'segm'):
            if m not in metrics:
                continue
            dets = self._det2json(results) if m == 'bbox' \
                else self._segm2json(results)
            coco_dt = self.coco.loadRes(dets) if dets \
                else COCO.from_dict(_EMPTY)
            ev = COCOEvaluator(self.coco, iou_type=m, iou_thrs=iou_thrs)
            ev.img_ids = self.img_ids
            stats = ev.evaluate(coco_dt)['stats']
            out.update({(f'{m}_mAP' if k == 'AP' else f'{m}_{k}'): stats[k]
                        for k in STATS})
        if 'proposal' in metrics or 'proposal_fast' in metrics:
            gts = [self.get_ann_info(i)['bboxes'] for i in range(len(self))]
            props = [np.vstack(r) if isinstance(r, list) else r
                     for r in results]
            ar = eval_recalls(gts, props, list(proposal_nums),
                              np.arange(0.5, 0.96, 0.05)).mean(axis=1)
            out.update({f'AR@{n}': float(a)
                        for n, a in zip(proposal_nums, ar)})
        return out


@DATASETS.register_module()
class VisdroneDataset(CocoDataset):
    """VisDrone-DET in COCO form: 12 classes, the first of them the ignored
    regions (ref: mmdet/datasets/visdrone.py:5-11)."""
    CLASSES = ('ignored-regions', 'pedestrian', 'people', 'bicycle', 'car',
               'van', 'truck', 'tricycle', 'awning-tricycle', 'bus', 'motor',
               'others')
