from .bbox_head import BBoxHead, ConvFCBBoxHead, Shared2FCBBoxHead

__all__ = ['BBoxHead', 'ConvFCBBoxHead', 'Shared2FCBBoxHead']
