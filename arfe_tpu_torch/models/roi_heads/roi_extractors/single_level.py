"""RoI extractor over FPN levels (counterpart of
``arfe_tpu/models/roi_heads/roi_extractors/single_level.py:19-78``).

The target level of every RoI is computed here, from the RoIs or from
``replace_rois``, shifted by ``lvl``, and always handed to
:func:`roi_align_pyramid`; ``roi_scale_factor`` rescales the boxes after
their levels are fixed. So every argument reaches the CUDA kernel.

The RoIs get no gradient: they are detached here, so the CPU's plain path
gives what :class:`RoIAlignFunction` gives on the card, and what the JAX
package's kernel path gives (``arfe_tpu/ops/pallas_roi_align.py:407-435``).
"""
from __future__ import annotations

import torch
from torch import nn

from ....ops.roi_align import map_roi_levels, roi_align_pyramid
from ....registry import ROI_EXTRACTORS


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor(nn.Module):
    def __init__(self, roi_layer, out_channels, featmap_strides,
                 finest_scale=56):
        super().__init__()
        cfg = dict(roi_layer)
        layer_type = cfg.pop('type')
        if layer_type != 'RoIAlign':
            raise NotImplementedError(f'roi layer {layer_type!r} is not '
                                      'ported')
        out_size = cfg.pop('out_size', 7)
        self.out_size = (out_size, out_size) if isinstance(out_size, int) \
            else tuple(out_size)
        self.sample_num = cfg.pop('sample_num', 0)
        self.aligned = cfg.pop('aligned', True)
        self.out_channels = out_channels
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale

    @property
    def num_inputs(self):
        return len(self.featmap_strides)

    @staticmethod
    def roi_rescale(rois, scale_factor):
        """Scale RoI width and height about the center."""
        cx = (rois[:, 1] + rois[:, 3]) * 0.5
        cy = (rois[:, 2] + rois[:, 4]) * 0.5
        w = (rois[:, 3] - rois[:, 1]) * scale_factor
        h = (rois[:, 4] - rois[:, 2]) * scale_factor
        return torch.stack([rois[:, 0], cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5, cy + h * 0.5], dim=-1)

    def forward(self, feats, rois, roi_scale_factor=None, lvl=None,
                replace_rois=None):
        """feats: per-level (B, C, H, W); rois (R, 5) -> (R, oh, ow, C)."""
        rois = rois.detach()
        if replace_rois is not None:
            replace_rois = replace_rois.detach()
        num_levels = self.num_inputs
        lvl_src = replace_rois if replace_rois is not None else rois
        target_lvls = map_roi_levels(lvl_src, num_levels, self.finest_scale)
        if lvl is not None:
            target_lvls = torch.clamp(target_lvls + lvl, 0,
                                      num_levels - 1).to(torch.int32)
        if roi_scale_factor is not None:
            rois = self.roi_rescale(rois, roi_scale_factor)
        nhwc = [f.permute(0, 2, 3, 1).contiguous()
                for f in feats[:num_levels]]
        return roi_align_pyramid(nhwc, rois.float().contiguous(),
                                 target_lvls.contiguous(), self.out_size,
                                 self.featmap_strides, self.sample_num,
                                 self.aligned)
