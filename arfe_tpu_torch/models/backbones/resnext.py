"""ResNeXt backbone (counterpart of
``arfe_tpu/models/backbones/resnext.py:13-69``): the ResNet body with
grouped bottlenecks. A stage of ``planes`` runs its 3x3 conv over
``int(planes * base_width / 64) * groups`` channels in ``groups`` groups
(``groups=1`` is ResNet's bottleneck), in either style. Parameter names are
ResNet's; the grouped conv's weight is torch's (O, I / groups, 3, 3), which
``convert.jax2torch`` makes from the JAX package's (3, 3, I / groups, O).
"""
from __future__ import annotations

from ...registry import BACKBONES
from .resnet import Bottleneck, ResNet


class BottleneckX(Bottleneck):
    def __init__(self, inplanes, planes, groups=1, base_width=4, **kwargs):
        width = int(planes * (base_width / 64)) * groups \
            if groups != 1 else planes
        super().__init__(inplanes, planes, groups=groups, width=width,
                         **kwargs)


@BACKBONES.register_module()
class ResNeXt(ResNet):
    arch_settings = {
        50: (BottleneckX, (3, 4, 6, 3)),
        101: (BottleneckX, (3, 4, 23, 3)),
        152: (BottleneckX, (3, 8, 36, 3)),
    }

    def __init__(self, groups=1, base_width=4, **kwargs):
        self.groups = groups
        self.base_width = base_width
        super().__init__(**kwargs)

    def make_block(self, block_cls, inplanes, planes, **kwargs):
        return block_cls(inplanes, planes, groups=self.groups,
                         base_width=self.base_width, **kwargs)
