from .resnet import ResNet
from .resnext import ResNeXt

__all__ = ['ResNeXt', 'ResNet']
