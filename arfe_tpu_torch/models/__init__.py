"""Models of the port; importing this registers them."""
from .. import core  # noqa: F401  (registers anchors and box coders)
from . import (backbones, dense_heads, detectors, losses,  # noqa: F401
               necks, roi_heads)
from .builder import build_detector

__all__ = ['build_detector']
