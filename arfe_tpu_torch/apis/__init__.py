from .inference import inference_detector, init_detector
from .test import single_device_test

__all__ = ['inference_detector', 'init_detector', 'single_device_test']
