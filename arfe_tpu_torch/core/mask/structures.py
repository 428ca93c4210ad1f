"""Mask containers of the data pipeline, in numpy on the host (counterpart of
``arfe_tpu/core/mask/structures.py:17-209``), with the methods the Mask
R-CNN path uses.

The JAX package resizes and rasterises through OpenCV, which the port's
machines lack; ``data.image_io`` gives the same arrays: ``fill_poly`` is
``cv2.fillPoly`` pixel for pixel, the nearest resize is ``INTER_NEAREST``
exactly, and the float bilinear resize of :meth:`BitmapMasks.
crop_and_resize` lies within one float32 ulp of ``INTER_LINEAR``. The data
package imports this module, so ``image_io`` is imported where it is used.
"""
from __future__ import annotations

import numpy as np



def _rescale_factor(scale, h, w):
    """mmcv's ``rescale`` factor: a number, or the largest factor that fits
    (h, w) inside the (long, short) edges of ``scale``."""
    if isinstance(scale, (int, float)):
        return scale
    max_long, max_short = max(scale), min(scale)
    return min(max_long / max(h, w), max_short / min(h, w))


class BitmapMasks:
    """(N, H, W) uint8 instance masks (ref: structures.py:59-283)."""

    def __init__(self, masks, height, width):
        self.height = height
        self.width = width
        if len(masks) == 0:
            self.masks = np.empty((0, height, width), dtype=np.uint8)
        else:
            if isinstance(masks, (list, tuple)):
                masks = np.stack(masks).reshape(-1, height, width)
            self.masks = masks.astype(np.uint8)

    def __getitem__(self, index):
        masks = self.masks[index].reshape(-1, self.height, self.width)
        return BitmapMasks(masks, self.height, self.width)

    def __len__(self):
        return len(self.masks)

    def rescale(self, scale):
        """Each mask scaled by ``scale`` (a factor, or (long, short) edges),
        nearest neighbour; the size rounds half up, as mmcv's."""
        f = _rescale_factor(scale, self.height, self.width)
        new_h, new_w = int(self.height * f + 0.5), int(self.width * f + 0.5)
        return self.resize((new_h, new_w))

    def resize(self, out_shape):
        """Each mask resized to (h, w), nearest neighbour."""
        from ...data.image_io import imresize
        h, w = out_shape
        if len(self.masks) == 0:
            return BitmapMasks(np.empty((0, h, w), np.uint8), h, w)
        return BitmapMasks(np.stack([imresize(m, (w, h), 'nearest')
                                     for m in self.masks]), h, w)

    def flip(self, flip_direction='horizontal'):
        if flip_direction not in ('horizontal', 'vertical'):
            raise ValueError(f'flip: direction {flip_direction!r}')
        axis = 2 if flip_direction == 'horizontal' else 1
        return BitmapMasks(np.flip(self.masks, axis=axis).copy(),
                           self.height, self.width)

    def crop_and_resize(self, bboxes, out_shape):
        """Mask i cut to the pixels that box i covers (its corners floored
        and ceiled, at least one pixel) and resized bilinearly to
        ``out_shape``: (len(bboxes), h, w) float32 (ref:
        structures.py:204-243)."""
        from ...data.image_io import imresize
        out = np.zeros((len(bboxes),) + tuple(out_shape), np.float32)
        for i, box in enumerate(bboxes):
            x1, y1, x2, y2 = box
            xi1 = int(np.clip(np.floor(x1), 0, self.width))
            yi1 = int(np.clip(np.floor(y1), 0, self.height))
            xi2 = int(np.clip(np.ceil(x2), 0, self.width))
            yi2 = int(np.clip(np.ceil(y2), 0, self.height))
            patch = self.masks[i][yi1:max(yi2, yi1 + 1),
                                  xi1:max(xi2, xi1 + 1)]
            out[i] = imresize(patch.astype(np.float32),
                              (out_shape[1], out_shape[0]))
        return out

    def to_fixed_crops(self, gt_bboxes, crop_size=112):
        """Each mask cut to its gt box and resized to (crop_size,
        crop_size) float32: the fixed-size crops that the mask targets are
        resampled from on the device (``mask_target_from_crops``)."""
        return self.crop_and_resize(gt_bboxes, (crop_size, crop_size))


class PolygonMasks:
    """Instances as lists of polygons, flat [x0, y0, x1, y1, ...] arrays
    (ref: structures.py:284-533); rasterised by :meth:`to_bitmap`."""

    def __init__(self, masks, height, width):
        self.height = height
        self.width = width
        self.masks = masks

    def to_bitmap(self):
        """Each instance's polygons filled at once, as ``cv2.fillPoly`` on
        their points truncated to int32 (JAX ``structures.py:196-206``)."""
        from ...data.image_io import fill_poly
        bitmaps = []
        for poly in self.masks:
            m = np.zeros((self.height, self.width), np.uint8)
            fill_poly(m, [np.asarray(p).reshape(-1, 2).astype(np.int32)
                          for p in poly], 1)
            bitmaps.append(m)
        return BitmapMasks(bitmaps, self.height, self.width)
