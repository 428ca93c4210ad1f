from .two_stage import FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ['FasterRCNN', 'MaskRCNN', 'TwoStageDetector']
