from .anchor_head import AnchorHead
from .retina_head import RetinaHead
from .rpn_head import RPNHead

__all__ = ['AnchorHead', 'RPNHead', 'RetinaHead']
