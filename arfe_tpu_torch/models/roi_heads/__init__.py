from .bbox_heads import (BBoxHead, ConvFCBBoxHead, MultiBBoxHead,
                         MultiClassesBBoxHead, MultiRoIsBBoxHead,
                         Shared2FCBBoxHead, Shared2FCMultiClassesBBoxHead)
from .cascade_roi_head import CascadeRoIHead
from .mask_heads import FCNMaskHead
from .roi_extractors import SingleRoIExtractor
from .standard_roi_head import StandardRoIHead

__all__ = ['BBoxHead', 'CascadeRoIHead', 'ConvFCBBoxHead', 'FCNMaskHead', 'MultiBBoxHead',
           'MultiClassesBBoxHead', 'MultiRoIsBBoxHead', 'Shared2FCBBoxHead',
           'Shared2FCMultiClassesBBoxHead', 'SingleRoIExtractor',
           'StandardRoIHead']
