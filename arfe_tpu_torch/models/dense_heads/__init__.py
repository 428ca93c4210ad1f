from .anchor_head import AnchorHead
from .rpn_head import RPNHead

__all__ = ['AnchorHead', 'RPNHead']
