from .assigners import CenterRegionAssigner, MaxIoUAssigner, scale_boxes
from .coder import (DeltaXYWHBBoxCoder, LegacyDeltaXYWHBBoxCoder,
                    TBLRBBoxCoder, bbox2delta, delta2bbox, legacy_bbox2delta,
                    legacy_delta2bbox)
from .iou import bbox_overlaps
from .samplers import (CombinedSampler, InstanceBalancedPosSampler,
                       IoUBalancedNegSampler, OHEMSampler, PseudoSampler,
                       RandomSampler, RandomSamplerPrior, ScoreHLRSampler)
from .transforms import bbox2result

__all__ = ['CenterRegionAssigner', 'CombinedSampler', 'DeltaXYWHBBoxCoder',
           'InstanceBalancedPosSampler', 'IoUBalancedNegSampler',
           'LegacyDeltaXYWHBBoxCoder',
           'MaxIoUAssigner', 'OHEMSampler', 'PseudoSampler', 'RandomSampler',
           'RandomSamplerPrior', 'ScoreHLRSampler', 'TBLRBBoxCoder',
           'bbox2delta', 'bbox2result', 'bbox_overlaps', 'delta2bbox',
           'legacy_bbox2delta', 'legacy_delta2bbox', 'scale_boxes']
