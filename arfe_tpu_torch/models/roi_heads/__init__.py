from .bbox_heads import BBoxHead, ConvFCBBoxHead, Shared2FCBBoxHead
from .roi_extractors import SingleRoIExtractor
from .standard_roi_head import StandardRoIHead

__all__ = ['BBoxHead', 'ConvFCBBoxHead', 'Shared2FCBBoxHead',
           'SingleRoIExtractor', 'StandardRoIHead']
