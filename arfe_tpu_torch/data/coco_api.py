"""Minimal COCO annotation API: the subset of ``pycocotools.coco.COCO``
that the datasets and the evaluator use (index construction, id queries,
loading), as the reference uses it (ref: mmdet/datasets/coco.py:33-96).

The port's own copy of ``arfe_tpu/data/coco_api.py`` (the port imports
nothing of the JAX package), without the mask results, which come with
Mask R-CNN (ROADMAP §1).
"""
from __future__ import annotations

import json
from collections import defaultdict


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_ann_map = defaultdict(list)
        self.cat_img_map = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.create_index()

    @classmethod
    def from_dict(cls, dataset):
        obj = cls()
        obj.dataset = dataset
        obj.create_index()
        return obj

    def create_index(self):
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_ann_map = defaultdict(list)
        self.cat_img_map = defaultdict(list)
        for img in self.dataset.get('images', []):
            self.imgs[img['id']] = img
        for cat in self.dataset.get('categories', []):
            self.cats[cat['id']] = cat
        for ann in self.dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_ann_map[ann['image_id']].append(ann)
            if ann['image_id'] not in self.cat_img_map[ann['category_id']]:
                self.cat_img_map[ann['category_id']].append(ann['image_id'])

    # -- pycocotools-compatible accessors --
    def getImgIds(self, imgIds=None, catIds=None):
        if not catIds:
            ids = list(self.imgs.keys())
        else:
            ids = set()
            for i, cid in enumerate(catIds):
                if i == 0:
                    ids = set(self.cat_img_map[cid])
                else:
                    ids &= set(self.cat_img_map[cid])
            ids = list(ids)
        if imgIds:
            ids = [i for i in ids if i in set(imgIds)]
        return sorted(ids)

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c['name'] in catNms]
        if supNms:
            cats = [c for c in cats if c.get('supercategory') in supNms]
        if catIds:
            cats = [c for c in cats if c['id'] in catIds]
        return [c['id'] for c in cats]

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        if imgIds is not None and not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        if catIds is not None and not isinstance(catIds, (list, tuple)):
            catIds = [catIds]
        if imgIds:
            anns = []
            for iid in imgIds:
                anns.extend(self.img_ann_map[iid])
        else:
            anns = list(self.anns.values())
        if catIds:
            catset = set(catIds)
            anns = [a for a in anns if a['category_id'] in catset]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a['area'] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get('iscrowd', 0) == iscrowd]
        return [a['id'] for a in anns]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, results):
        """Build a result COCO object from a list of detection dicts
        (image_id, category_id, bbox [x,y,w,h], score)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = {'images': list(self.dataset.get('images', [])),
               'categories': list(self.dataset.get('categories', []))}
        anns = []
        for i, det in enumerate(results):
            ann = dict(det)
            ann['id'] = i + 1
            if isinstance(ann.get('segmentation'), dict):
                raise NotImplementedError(
                    'loadRes: mask results come with Mask R-CNN')
            if 'bbox' in ann and 'area' not in ann:
                x, y, w, h = ann['bbox']
                ann['area'] = w * h
            ann.setdefault('iscrowd', 0)
            anns.append(ann)
        res['annotations'] = anns
        return COCO.from_dict(res)
