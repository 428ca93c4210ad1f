"""A synthetic COCO-style data set written without OpenCV: smooth random PNG
images and, once a detector has run over them, ground truth seeded from its
detections (jittered) plus boxes nothing detects, so that AP lies inside
(0, 1). The tests and ``chip_smoke.py`` evaluate on it."""
from __future__ import annotations

import json
import os

import numpy as np

from .coco import CocoDataset
from .image_io import imresize, imwrite_png

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
        small = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3))
        imwrite_png(os.path.join(root, 'imgs', f'{i}.png'),
                    imresize(small.astype(np.uint8), (w, h)))
        images.append(dict(id=i + 1, width=w, height=h, file_name=f'{i}.png'))
    return images


def write_annotations(path, images, annotations=()):
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=list(annotations),
                       categories=CATEGORIES), f)


def seed_ground_truth(images, results, seed=3):
    """Each image's four best detections (``results``: per image, per-class
    (k, 5) arrays in the image's coordinates), jittered by up to 4% of their
    size, as ground truth, and two random boxes of 20-60 px nothing need
    detect. Returns the COCO ``annotations``."""
    rng = np.random.RandomState(seed)
    anns = []

    def add(img, cat, x1, y1, x2, y2):
        anns.append(dict(id=len(anns) + 1, image_id=img['id'],
                         category_id=cat, bbox=[x1, y1, x2 - x1, y2 - y1],
                         area=(x2 - x1) * (y2 - y1), iscrowd=0))

    for img, per_class in zip(images, results):
        w, h = img['width'], img['height']
        dets = [(box[4], c, box[:4]) for c, boxes in enumerate(per_class)
                for box in boxes]
        for _, c, box in sorted(dets, key=lambda d: -d[0])[:4]:
            x1, y1, x2, y2 = [float(v) for v in box]
            j = rng.uniform(-0.04, 0.04, 4) * max(x2 - x1, y2 - y1)
            x1, y1 = max(x1 + j[0], 0.0), max(y1 + j[1], 0.0)
            x2, y2 = min(x2 + j[2], w - 1.0), min(y2 + j[3], h - 1.0)
            if x2 - x1 >= 2 and y2 - y1 >= 2:
                add(img, CATEGORIES[c]['id'], x1, y1, x2, y2)
        for _ in range(2):
            bw, bh = rng.randint(20, 60, 2)
            x, y = rng.randint(0, w - bw - 1), rng.randint(0, h - bh - 1)
            add(img, int(rng.randint(1, len(CATEGORIES) + 1)), float(x),
                float(y), float(x + bw), float(y + bh))
    return anns
