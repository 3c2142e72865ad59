"""Model registry of the port: the flagship RefineNet, the single-image
family (Bicubic, EDSRNet, SRFBNet, DRFSISRNet), the multi-frame family
(DUFNet, RBPNet, TOFlowNet, and EDVRNet with its deformable convs) and the
plain video family (DRFNet, FRVSRNet)."""
from ..config import NETS
from .bicubic import Bicubic
from .duf_net import DUFNet
from .edsr_net import EDSRNet
from .edvr_net import EDVRNet
from .frvsr_net import FRVSRNet
from .rbp_net import RBPNet
from .refine_net import RefineNet
from .srfb_net import DRFNet, DRFSISRNet, SRFBNet
from .toflow_net import TOFlowNet

for _net in (Bicubic, EDSRNet, SRFBNet, DRFSISRNet, RefineNet, DUFNet, RBPNet, TOFlowNet,
             EDVRNet, DRFNet, FRVSRNet):
    NETS.add(_net.__name__, _net)

__all__ = ["Bicubic", "EDSRNet", "SRFBNet", "DRFSISRNet", "RefineNet", "DUFNet", "RBPNet",
           "TOFlowNet", "EDVRNet", "DRFNet", "FRVSRNet"]
