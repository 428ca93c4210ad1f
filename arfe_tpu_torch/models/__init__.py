"""Models of the port; importing this registers them."""
from .. import core  # noqa: F401  (registers anchors and box coders)
from . import backbones, dense_heads, detectors, necks, roi_heads  # noqa: F401
from .builder import build_detector

__all__ = ['build_detector']
