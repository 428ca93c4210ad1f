"""COCO's run-length encoding, uncompressed, and the mask IoU of the
``segm`` evaluation (the port's own copy of ``arfe_tpu/core/mask/rle.py``;
pycocotools is not installed). An RLE is ``{'size': [h, w], 'counts':
[n0, n1, ...]}``: column-major runs, the first of zeros."""
from __future__ import annotations

import numpy as np



def mask_to_rle(mask):
    """Binary (H, W) array -> uncompressed RLE."""
    mask = np.asarray(mask, dtype=np.uint8)
    h, w = mask.shape
    flat = mask.flatten(order='F')
    if not flat.size:
        return {'size': [int(h), int(w)], 'counts': [0]}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:          # the counts start with a run of zeros
        counts = [0] + counts
    return {'size': [int(h), int(w)], 'counts': counts}


def rle_to_mask(rle):
    """Uncompressed RLE -> binary (H, W) uint8."""
    h, w = rle['size']
    counts = np.asarray(rle['counts'], np.int64)
    # +1 at the start of each run of ones, -1 past its end
    bounds = np.cumsum(counts)
    steps = np.zeros(h * w + 1, np.int8)
    np.add.at(steps, np.minimum(bounds[0::2][:len(counts) // 2], h * w), 1)
    np.add.at(steps, np.minimum(bounds[1::2], h * w), -1)
    return np.cumsum(steps[:-1], dtype=np.int8).astype(np.uint8).reshape(
        (h, w), order='F')


def rle_area(rle):
    return int(sum(rle['counts'][1::2]))


def rle_to_bbox(rle):
    """The tight [x, y, w, h] box of an RLE (pycocotools' ``toBbox``)."""
    ys, xs = np.nonzero(rle_to_mask(rle))
    if ys.size == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def ann_to_mask(ann, height, width):
    """An annotation's ``segmentation`` (polygons, an uncompressed RLE or a
    binary array; or the segmentation itself) as (H, W) uint8. Polygons of
    at least 3 points are filled at once with their vertices rounded."""
    seg = ann.get('segmentation') if isinstance(ann, dict) else ann
    if seg is None:
        return np.zeros((height, width), np.uint8)
    if isinstance(seg, np.ndarray):
        return seg.astype(np.uint8)
    if isinstance(seg, dict):
        if isinstance(seg.get('counts'), (list, tuple)):
            return rle_to_mask(seg)
        raise ValueError('compressed RLE strings are not supported '
                         '(pycocotools is not installed)')
    from ...data.image_io import fill_poly   # data imports this module
    m = np.zeros((height, width), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in seg if len(p) >= 6]
    if pts:
        fill_poly(m, pts, 1)
    return m


def mask_iou(dt_masks, gt_masks, iscrowd=None):
    """(num_dt, num_gt) float64 IoU of binary (H, W) masks, pycocotools'
    rule: a crowd gt's denominator is the detection's area (IoF)."""
    nd, ng = len(dt_masks), len(gt_masks)
    out = np.zeros((nd, ng), np.float64)
    if nd == 0 or ng == 0:
        return out
    d = np.asarray(dt_masks, bool).reshape(nd, -1).astype(np.float64)
    g = np.asarray(gt_masks, bool).reshape(ng, -1).astype(np.float64)
    inter = d @ g.T
    d_area, g_area = d.sum(1), g.sum(1)
    crowd = np.zeros(ng, bool) if iscrowd is None \
        else np.asarray(iscrowd, bool)
    denom = np.where(crowd[None, :], d_area[:, None],
                     d_area[:, None] + g_area[None, :] - inter)
    return np.where(denom > 0, inter / np.maximum(denom, 1), 0.0)
