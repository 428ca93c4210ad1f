from .fpn import FPN
from .wfpn import WFPNDualSpatial

__all__ = ['FPN', 'WFPNDualSpatial']
