"""Anchor generation (counterpart of ``arfe_tpu/core/anchor/generator.py``,
``AnchorGenerator``). Anchors depend only on the feature-map sizes, so they
are numpy arrays computed on the host."""
from __future__ import annotations

import numpy as np

from ...registry import ANCHOR_GENERATORS


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


@ANCHOR_GENERATORS.register_module()
class AnchorGenerator:
    """Standard 2D anchors: base sizes default to the strides, ratio applied
    as ``h *= sqrt(ratio), w /= sqrt(ratio)``, scale-major order, centers at
    ``center_offset * base_size``."""

    def __init__(self, strides, ratios, scales=None, base_sizes=None,
                 scale_major=True, octave_base_scale=None,
                 scales_per_octave=None, center_offset=0.):
        self.strides = [_pair(s) for s in strides]
        self.base_sizes = ([min(s) for s in self.strides]
                           if base_sizes is None else list(base_sizes))
        if (octave_base_scale is not None
                and scales_per_octave is not None) == (scales is not None):
            raise ValueError('AnchorGenerator: give scales, or '
                             'octave_base_scale and scales_per_octave')
        if scales is not None:
            self.scales = np.array(scales, dtype=np.float32)
        else:
            octave_scales = np.array(
                [2**(i / scales_per_octave) for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale).astype(np.float32)
        self.ratios = np.array(ratios, dtype=np.float32)
        self.scale_major = scale_major
        self.center_offset = center_offset
        self.base_anchors = [self._base_anchors(b) for b in self.base_sizes]

    @property
    def num_base_anchors(self):
        return [ba.shape[0] for ba in self.base_anchors]

    def _base_anchors(self, base_size):
        w = h = float(base_size)
        x_center = self.center_offset * w
        y_center = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack([x_center - 0.5 * ws, y_center - 0.5 * hs,
                         x_center + 0.5 * ws, y_center + 0.5 * hs],
                        axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes):
        """Per level an (H*W*A, 4) array, the A anchors of a cell together."""
        out = []
        for base, (feat_h, feat_w), stride in zip(
                self.base_anchors, featmap_sizes, self.strides):
            shift_x = np.arange(0, feat_w, dtype=np.float32) * stride[0]
            shift_y = np.arange(0, feat_h, dtype=np.float32) * stride[1]
            shift_xx = np.tile(shift_x, len(shift_y))
            shift_yy = np.repeat(shift_y, len(shift_x))
            shifts = np.stack([shift_xx, shift_yy, shift_xx, shift_yy], -1)
            out.append((base[None] + shifts[:, None]).reshape(-1, 4)
                       .astype(np.float32))
        return out

    def valid_flags(self, featmap_sizes, pad_shape):
        """Per level an (H*W*A,) bool array: anchors whose grid cell lies
        inside the ``pad_shape`` (h, w) image, in the order of
        :meth:`grid_anchors`."""
        flags = []
        for (feat_h, feat_w), (sw, sh), num in zip(
                featmap_sizes, self.strides, self.num_base_anchors):
            valid_h = min(int(np.ceil(pad_shape[0] / sh)), feat_h)
            valid_w = min(int(np.ceil(pad_shape[1] / sw)), feat_w)
            vx = np.arange(feat_w) < valid_w
            vy = np.arange(feat_h) < valid_h
            valid = np.tile(vx, feat_h) & np.repeat(vy, feat_w)
            flags.append(np.repeat(valid, num))
        return flags
