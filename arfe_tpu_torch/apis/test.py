"""Dataset evaluation on one device (counterpart of
``arfe_tpu/apis/test.py:20-35,97-158``: ``single_device_test`` with masks,
without test-time augmentation, and ``encode_mask_results``). Evaluation
over several devices comes with data parallel (ROADMAP §1).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.mask.rle import mask_to_rle
from .inference import batch_to_device, detections_to_results


def encode_mask_results(mask_results):
    """Each mask of ``(bbox, segm)`` results as an uncompressed COCO RLE
    (ref: mmdet/apis/test.py ``encode_mask_results``); other results, and
    masks already encoded, are kept."""
    encoded = []
    for res in mask_results:
        if not isinstance(res, tuple):
            encoded.append(res)
            continue
        det, seg = res
        encoded.append((det, [[m if isinstance(m, dict)
                               else mask_to_rle(np.asarray(m))
                               for m in cls_masks] for cls_masks in seg]))
    return encoded


def single_device_test(model, data_loader, show_progress=True,
                       dtype=torch.float32):
    """(ref: apis/test.py:37-60 single_gpu_test). Runs every batch of
    ``data_loader`` through ``model.simple_test(..., rescale=True)`` on the
    model's device, with images in ``dtype``. Returns the reference's
    result format: per image, ``num_classes`` (k, 5) float32 arrays; for a
    mask model the pair ``(bbox, segm)``, the masks pasted at the original
    image's size and RLE-encoded batch by batch
    (:func:`encode_mask_results`)."""
    device = next(model.parameters()).device
    n_classes = model.num_classes
    results = []
    t0 = time.time()
    for batch in data_loader:
        out = model.simple_test(*batch_to_device(batch, device, dtype),
                                rescale=True)
        results.extend(encode_mask_results(detections_to_results(
            out, n_classes, [m['ori_shape'] for m in batch['img_metas']])))
        if show_progress:
            rate = len(results) / max(time.time() - t0, 1e-6)
            print(f'\r{len(results)} imgs, {rate:.1f} img/s', end='',
                  flush=True)
    if show_progress:
        print()
    return results
