from .rpn import RPN
from .single_stage import FSAF, RetinaNet, SingleStageDetector
from .two_stage import CascadeRCNN, FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ['CascadeRCNN', 'FSAF', 'FasterRCNN', 'MaskRCNN', 'RPN',
           'RetinaNet', 'SingleStageDetector', 'TwoStageDetector']
