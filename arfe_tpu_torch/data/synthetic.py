"""Synthetic COCO-style data sets written without OpenCV.

- Evaluation: smooth random PNG images and, once a detector has run over
  them, ground truth seeded from its detections (jittered) plus boxes
  nothing detects, so that AP lies inside (0, 1).
- Training: :func:`write_box_set`, solid rectangles on the same smooth
  background, each box its ground truth (the port's copy of the set
  ``tools/e2e_smoke.py`` draws with OpenCV); :func:`write_polygon_set`,
  solid polygons (star-shaped, often concave), each an instance with its
  polygon as ``segmentation``, for Mask R-CNN.

The tests, ``tools/e2e_smoke.py`` and ``chip_smoke.py`` train and evaluate
on them."""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.mask.rle import mask_to_rle, rle_area
from .coco import CocoDataset
from .image_io import fill_poly, imresize, imwrite_png

CATEGORIES = [dict(id=i + 1, name=name)
              for i, name in enumerate(CocoDataset.CLASSES)]


def write_images(root, sizes, seed=0):
    """PNGs ``root/imgs/{i}.png`` of (h, w) ``sizes``: random colours every
    16 px, bilinearly upsampled. Returns the COCO ``images`` entries (ids
    from 1)."""
    os.makedirs(os.path.join(root, 'imgs'), exist_ok=True)
    rng = np.random.RandomState(seed)
    images = []
    for i, (h, w) in enumerate(sizes):
        imwrite_png(os.path.join(root, 'imgs', f'{i}.png'),
                    _background(rng, h, w))
        images.append(dict(id=i + 1, width=w, height=h, file_name=f'{i}.png'))
    return images


def _background(rng, h, w):
    small = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3))
    return imresize(small.astype(np.uint8), (w, h))


def write_annotations(path, images, annotations=(), categories=CATEGORIES):
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=list(annotations),
                       categories=list(categories)), f)


def seed_ground_truth(images, results, seed=3):
    """Each image's four best detections (``results``: per image, per-class
    (k, 5) arrays in the image's coordinates), jittered by up to 4% of their
    size, as ground truth, and two random boxes of 20-60 px nothing need
    detect. For a mask model's ``(bbox, segm)`` results each seeded
    instance also takes its detection's mask as ``segmentation``
    (uncompressed RLE; area its pixels) and each random box its rectangle
    as a polygon. Returns the COCO ``annotations``."""
    rng = np.random.RandomState(seed)
    anns = []

    def add(img, cat, x1, y1, x2, y2, segm=None):
        ann = dict(id=len(anns) + 1, image_id=img['id'], category_id=cat,
                   bbox=[x1, y1, x2 - x1, y2 - y1],
                   area=(x2 - x1) * (y2 - y1), iscrowd=0)
        if segm is not None:
            ann.update(segmentation=segm, area=float(rle_area(segm))
                       if isinstance(segm, dict) else ann['area'])
        anns.append(ann)

    for img, result in zip(images, results):
        per_class, masks = result if isinstance(result, tuple) \
            else (result, None)
        w, h = img['width'], img['height']
        dets = [(box[4], c, box[:4], None if masks is None else masks[c][k])
                for c, boxes in enumerate(per_class)
                for k, box in enumerate(boxes)]
        for _, c, box, mask in sorted(dets, key=lambda d: -d[0])[:4]:
            x1, y1, x2, y2 = [float(v) for v in box]
            j = rng.uniform(-0.04, 0.04, 4) * max(x2 - x1, y2 - y1)
            x1, y1 = max(x1 + j[0], 0.0), max(y1 + j[1], 0.0)
            x2, y2 = min(x2 + j[2], w - 1.0), min(y2 + j[3], h - 1.0)
            if mask is not None and not isinstance(mask, dict):
                mask = mask_to_rle(mask)
            if x2 - x1 >= 2 and y2 - y1 >= 2 \
                    and (mask is None or rle_area(mask) > 0):
                add(img, CATEGORIES[c]['id'], x1, y1, x2, y2, mask)
        for _ in range(2):
            bw, bh = rng.randint(20, 60, 2)
            x, y = rng.randint(0, w - bw - 1), rng.randint(0, h - bh - 1)
            rect = None if masks is None else [[
                float(x), float(y), float(x + bw), float(y),
                float(x + bw), float(y + bh), float(x), float(y + bh)]]
            add(img, int(rng.randint(1, len(CATEGORIES) + 1)), float(x),
                float(y), float(x + bw), float(y + bh), rect)
    return anns


def write_box_set(root, sizes, boxes_per_image=(3, 6), seed=0,
                  categories=CATEGORIES):
    """PNGs ``root/imgs/{i}.png`` of (h, w) ``sizes``, each the smooth
    background of :func:`write_images` with ``boxes_per_image`` (lo, hi)
    solid rectangles of random colour, of 8-40% of the image's shorter side,
    and ``root/ann.json``: each rectangle a box of a random one of
    ``categories`` (by default COCO's 80). Returns the COCO ``images`` and
    ``annotations``."""
    os.makedirs(os.path.join(root, 'imgs'), exist_ok=True)
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = _background(rng, h, w)
        side = min(h, w)
        for _ in range(rng.randint(boxes_per_image[0],
                                   boxes_per_image[1] + 1)):
            bw, bh = rng.randint(max(int(side * 0.08), 4), int(side * 0.4),
                                 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=categories[rng.randint(len(categories))]['id'],
                bbox=[float(x), float(y), float(bw), float(bh)],
                area=float(bw * bh), iscrowd=0))
        imwrite_png(os.path.join(root, 'imgs', f'{i}.png'), img)
        images.append(dict(id=i + 1, width=w, height=h, file_name=f'{i}.png'))
    write_annotations(os.path.join(root, 'ann.json'), images, anns,
                      categories)
    return images, anns


def write_polygon_set(root, sizes, instances_per_image=(3, 6), seed=0,
                      categories=CATEGORIES):
    """PNGs ``root/imgs/{i}.png`` of (h, w) ``sizes``, each the smooth
    background of :func:`write_images` with ``instances_per_image`` (lo, hi)
    solid polygons of random colour: 5-12 vertices at random angles and
    radii of 30-100% of a radius of 8-25% of the image's shorter side (so
    often concave), and ``root/ann.json``: each polygon an instance of a
    random one of ``categories``, with its vertices (floats) as
    ``segmentation``, their tight box as ``bbox`` and its filled pixels
    (``fill_poly`` of the vertices rounded, as the evaluator fills them)
    as ``area``. Returns the COCO ``images`` and ``annotations``."""
    os.makedirs(os.path.join(root, 'imgs'), exist_ok=True)
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = _background(rng, h, w)
        side = min(h, w)
        for _ in range(rng.randint(instances_per_image[0],
                                   instances_per_image[1] + 1)):
            k = rng.randint(5, 13)
            radius = side * rng.uniform(0.08, 0.25)
            cx = rng.uniform(radius, w - radius)
            cy = rng.uniform(radius, h - radius)
            angle = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = radius * rng.uniform(0.3, 1.0, k)
            pts = np.stack([cx + r * np.cos(angle), cy + r * np.sin(angle)],
                           1).round(2)
            mask = fill_poly(np.zeros((h, w), np.uint8),
                             [pts.round().astype(np.int32)], 1)
            img[mask > 0] = rng.randint(0, 256, 3)
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=categories[rng.randint(len(categories))]['id'],
                segmentation=[pts.ravel().tolist()],
                bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                area=float(mask.sum()), iscrowd=0))
        imwrite_png(os.path.join(root, 'imgs', f'{i}.png'), img)
        images.append(dict(id=i + 1, width=w, height=h, file_name=f'{i}.png'))
    write_annotations(os.path.join(root, 'ann.json'), images, anns,
                      categories)
    return images, anns
