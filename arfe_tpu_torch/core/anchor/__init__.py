from .generator import AnchorGenerator

__all__ = ['AnchorGenerator']
