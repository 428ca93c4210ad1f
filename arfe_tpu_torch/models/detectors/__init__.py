from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ['FasterRCNN', 'TwoStageDetector']
