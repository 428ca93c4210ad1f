from .assigners import MaxIoUAssigner
from .coder import DeltaXYWHBBoxCoder, bbox2delta, delta2bbox
from .iou import bbox_overlaps
from .samplers import PseudoSampler, RandomSampler
from .transforms import bbox2result

__all__ = ['DeltaXYWHBBoxCoder', 'MaxIoUAssigner', 'PseudoSampler',
           'RandomSampler',
           'bbox2delta', 'bbox2result', 'bbox_overlaps', 'delta2bbox']
