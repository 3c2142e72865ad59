"""Model registry of the port: the flagship RefineNet and the single-image
family (Bicubic, EDSRNet, SRFBNet, DRFSISRNet)."""
from ..config import NETS
from .bicubic import Bicubic
from .edsr_net import EDSRNet
from .refine_net import RefineNet
from .srfb_net import DRFSISRNet, SRFBNet

for _net in (Bicubic, EDSRNet, SRFBNet, DRFSISRNet, RefineNet):
    NETS.add(_net.__name__, _net)

__all__ = ["Bicubic", "EDSRNet", "SRFBNet", "DRFSISRNet", "RefineNet"]
