from .experimental_fpns import FPNBU, FPNCBAM, CbamModule, FPNRelation
from .fpn import FPN
from .wfpn import BFP, WFPNDualSpatial

__all__ = ['BFP', 'CbamModule', 'FPN', 'FPNBU', 'FPNCBAM', 'FPNRelation',
           'WFPNDualSpatial']
