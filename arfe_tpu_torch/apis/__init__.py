from .inference import inference_detector, init_detector
from .test import encode_mask_results, single_device_test
from .train import set_random_seed, train_detector

__all__ = ['encode_mask_results', 'inference_detector', 'init_detector',
           'set_random_seed', 'single_device_test', 'train_detector']
