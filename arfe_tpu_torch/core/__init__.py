"""Anchors, box coding and post-processing of the port; importing this
registers the anchor generator and the box coder."""
from . import anchor, bbox  # noqa: F401
