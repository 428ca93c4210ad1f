from .checkpoint import load_checkpoint, save_checkpoint
from .collect_env import collect_env
from .logger import get_root_logger
from .pretrained import load_pretrained_backbone

__all__ = ['collect_env', 'get_root_logger', 'load_checkpoint',
           'load_pretrained_backbone', 'save_checkpoint']
