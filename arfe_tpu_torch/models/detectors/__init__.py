from .single_stage import RetinaNet, SingleStageDetector
from .two_stage import CascadeRCNN, FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ['CascadeRCNN', 'FasterRCNN', 'MaskRCNN', 'RetinaNet',
           'SingleStageDetector', 'TwoStageDetector']
