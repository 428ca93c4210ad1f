from .fpn import FPN
from .wfpn import BFP, WFPNDualSpatial

__all__ = ['BFP', 'FPN', 'WFPNDualSpatial']
