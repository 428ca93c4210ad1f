from .bbox_heads import (BBoxHead, ConvFCBBoxHead, MultiBBoxHead,
                         MultiClassesBBoxHead, MultiRoIsBBoxHead,
                         Shared2FCBBoxHead, Shared2FCMultiClassesBBoxHead)
from .roi_extractors import SingleRoIExtractor
from .standard_roi_head import StandardRoIHead

__all__ = ['BBoxHead', 'ConvFCBBoxHead', 'MultiBBoxHead',
           'MultiClassesBBoxHead', 'MultiRoIsBBoxHead', 'Shared2FCBBoxHead',
           'Shared2FCMultiClassesBBoxHead', 'SingleRoIExtractor',
           'StandardRoIHead']
