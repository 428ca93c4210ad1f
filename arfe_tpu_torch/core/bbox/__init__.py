from .assigners import MaxIoUAssigner
from .coder import (DeltaXYWHBBoxCoder, LegacyDeltaXYWHBBoxCoder,
                    bbox2delta, delta2bbox, legacy_bbox2delta,
                    legacy_delta2bbox)
from .iou import bbox_overlaps
from .samplers import (CombinedSampler, InstanceBalancedPosSampler,
                       IoUBalancedNegSampler, OHEMSampler, PseudoSampler,
                       RandomSampler, RandomSamplerPrior, ScoreHLRSampler)
from .transforms import bbox2result

__all__ = ['CombinedSampler', 'DeltaXYWHBBoxCoder',
           'InstanceBalancedPosSampler', 'IoUBalancedNegSampler',
           'LegacyDeltaXYWHBBoxCoder',
           'MaxIoUAssigner', 'OHEMSampler', 'PseudoSampler', 'RandomSampler',
           'RandomSamplerPrior', 'ScoreHLRSampler',
           'bbox2delta', 'bbox2result', 'bbox_overlaps', 'delta2bbox',
           'legacy_bbox2delta', 'legacy_delta2bbox']
