from .inference import init_detector

__all__ = ['init_detector']
