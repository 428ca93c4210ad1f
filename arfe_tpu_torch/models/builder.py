"""Model builders (counterpart of ``arfe_tpu/models/builder.py``). A
list-valued neck config becomes an ``nn.Sequential``, so its parameters are
named ``neck.0.*``, ``neck.1.*`` as in the reference."""
from __future__ import annotations

from torch import nn

from ..registry import (BACKBONES, DETECTORS, HEADS, NECKS, ROI_EXTRACTORS,
                        build_from_cfg)


def build_backbone(cfg):
    return build_from_cfg(cfg, BACKBONES)


def build_neck(cfg):
    if isinstance(cfg, (list, tuple)):
        return nn.Sequential(*[build_from_cfg(c, NECKS) for c in cfg])
    return build_from_cfg(cfg, NECKS)


def build_head(cfg):
    return build_from_cfg(cfg, HEADS)


def build_roi_extractor(cfg):
    return build_from_cfg(cfg, ROI_EXTRACTORS)


def build_detector(cfg, train_cfg=None, test_cfg=None):
    return build_from_cfg(cfg, DETECTORS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg))
