from .anchor_head import AnchorHead
from .fsaf_head import FSAFHead
from .retina_head import RetinaHead
from .rpn_head import RPNHead

__all__ = ['AnchorHead', 'FSAFHead', 'RPNHead', 'RetinaHead']
