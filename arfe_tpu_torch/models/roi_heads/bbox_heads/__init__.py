from .attrois_bbox_head import AttRoIsBBoxHead
from .bbox_head import BBoxHead, ConvFCBBoxHead, Shared2FCBBoxHead
from .multi_classes_bbox_head import (MultiClassesBBoxHead,
                                      Shared2FCMultiClassesBBoxHead)
from .multirois_bbox_head import MultiBBoxHead, MultiRoIsBBoxHead

__all__ = ['AttRoIsBBoxHead', 'BBoxHead', 'ConvFCBBoxHead', 'MultiBBoxHead',
           'MultiClassesBBoxHead', 'MultiRoIsBBoxHead', 'Shared2FCBBoxHead',
           'Shared2FCMultiClassesBBoxHead']
