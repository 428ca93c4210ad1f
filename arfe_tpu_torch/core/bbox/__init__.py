from .coder import DeltaXYWHBBoxCoder, delta2bbox
from .iou import bbox_overlaps
from .transforms import bbox2result

__all__ = ['DeltaXYWHBBoxCoder', 'delta2bbox', 'bbox_overlaps', 'bbox2result']
