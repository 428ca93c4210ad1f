"""Dataset evaluation on one device (counterpart of
``arfe_tpu/apis/test.py:97-158``, ``single_device_test`` without masks and
test-time augmentation). Evaluation over several devices comes with data
parallel (ROADMAP §1).
"""
from __future__ import annotations

import time

import torch

from .inference import batch_to_device, detections_to_results, num_classes


def single_device_test(model, data_loader, show_progress=True,
                       dtype=torch.float32):
    """(ref: apis/test.py:37-60 single_gpu_test). Runs every batch of
    ``data_loader`` through ``model.simple_test(..., rescale=True)`` on the
    model's device, with images in ``dtype``. Returns the reference's
    result format: per image, ``num_classes`` (k, 5) float32 arrays."""
    device = next(model.parameters()).device
    n_classes = num_classes(model)
    results = []
    t0 = time.time()
    for batch in data_loader:
        out = model.simple_test(*batch_to_device(batch, device, dtype),
                                rescale=True)
        results.extend(detections_to_results(*out, n_classes))
        if show_progress:
            rate = len(results) / max(time.time() - t0, 1e-6)
            print(f'\r{len(results)} imgs, {rate:.1f} img/s', end='',
                  flush=True)
    if show_progress:
        print()
    return results
