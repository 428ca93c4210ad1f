"""Mask targets of the training step and the paste of predicted masks (the
port's counterpart of ``arfe_tpu/core/mask/mask_target.py:15-87``).

The ground-truth masks reach the device as fixed-size crops, one per gt box
(``BitmapMasks.to_fixed_crops``, 112 x 112), and each sampled RoI's target
is a bilinear resample of its gt's crop onto the RoI's 28 x 28 grid,
thresholded at 0.5: static shapes on the device, in place of the
reference's per-RoI rasterisation on the host.
"""
from __future__ import annotations

import numpy as np
import torch



def _axis(coord, size):
    """Bilinear corners (i0, i1), weights (w0, w1) and validity of sample
    coordinates along one crop axis of ``size`` pixels."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    i0 = torch.floor(c).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w1 = c - i0.to(c.dtype)
    return i0, i1, 1.0 - w1, w1, (coord > -1.0) & (coord < size)


def mask_target_from_crops(gt_crops, gt_boxes, rois, mask_size=28):
    """Resample fixed gt-mask crops to RoI-aligned binary targets.

    Args:
        gt_crops: (S, cs, cs) float crops, each sampled RoI's matched gt's.
        gt_boxes: (S, 4) the matched gt boxes (image coordinates).
        rois: (S, 4) the sampled boxes (image coordinates).
    Returns:
        (S, mask_size, mask_size) float32 targets, 0 or 1: the crop's
        bilinear value at the centres of the RoI's mask cells, >= 0.5; 0
        where a centre falls outside the gt box's crop.
    """
    s, cs, _ = gt_crops.shape
    gt_crops = gt_crops.float()
    gx1, gy1 = gt_boxes[:, 0], gt_boxes[:, 1]
    gw = torch.clamp(gt_boxes[:, 2] - gt_boxes[:, 0], min=1e-2)
    gh = torch.clamp(gt_boxes[:, 3] - gt_boxes[:, 1], min=1e-2)
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1e-2)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1e-2)
    # divide tensor by tensor, as XLA does (on CUDA a division by a Python
    # scalar is a multiplication by its reciprocal)
    grid = (torch.arange(mask_size, dtype=torch.float32,
                         device=rois.device) + 0.5) \
        / torch.full((), float(mask_size), device=rois.device)
    xs = rois[:, 0, None] + grid[None, :] * rw[:, None]
    ys = rois[:, 1, None] + grid[None, :] * rh[:, None]
    u = (xs - gx1[:, None]) / gw[:, None] * cs - 0.5
    v = (ys - gy1[:, None]) / gh[:, None] * cs - 0.5
    x0, x1, wx0, wx1, in_x = _axis(u, cs)
    y0, y1, wy0, wy1, in_y = _axis(v, cs)
    b = torch.arange(s, device=rois.device)[:, None, None]

    def at(yi, xi):
        return gt_crops[b, yi[:, :, None], xi[:, None, :]]

    out = (at(y0, x0) * (wy0[:, :, None] * wx0[:, None, :])
           + at(y0, x1) * (wy0[:, :, None] * wx1[:, None, :])
           + at(y1, x0) * (wy1[:, :, None] * wx0[:, None, :])
           + at(y1, x1) * (wy1[:, :, None] * wx1[:, None, :]))
    out = torch.where(in_y[:, :, None] & in_x[:, None, :], out, 0.0)
    return (out >= 0.5).float()


def paste_masks_np(mask_pred, det_bboxes, img_h, img_w, thr=0.5):
    """Each (m, m) mask probability map resized bilinearly to its box
    (corners rounded, at least 1 x 1 pixel), thresholded (> ``thr``) and
    pasted into an (img_h, img_w) canvas: (N, img_h, img_w) uint8 (ref:
    fcn_mask_head.py:149-250 ``get_seg_masks``). Only the part of a box
    inside the image is resized."""
    from ...data.image_io import imresize   # data imports this module
    n = mask_pred.shape[0]
    out = np.zeros((n, img_h, img_w), dtype=np.uint8)
    for i in range(n):
        x1, y1, x2, y2 = det_bboxes[i, :4]
        w = max(int(np.round(x2 - x1)), 1)
        h = max(int(np.round(y2 - y1)), 1)
        x1i, y1i = int(np.round(x1)), int(np.round(y1))
        # the box's pixels inside the image, in box coordinates
        cols = slice(max(-x1i, 0), min(img_w - x1i, w))
        rows = slice(max(-y1i, 0), min(img_h - y1i, h))
        if cols.stop <= cols.start or rows.stop <= rows.start:
            continue
        mask = imresize(mask_pred[i].astype(np.float32), (w, h),
                        window=(rows, cols))
        out[i, rows.start + y1i:rows.stop + y1i,
            cols.start + x1i:cols.stop + x1i] = mask > thr
    return out
