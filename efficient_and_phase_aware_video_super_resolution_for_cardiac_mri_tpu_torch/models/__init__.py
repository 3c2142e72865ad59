"""Model registry of the port (this slice: the flagship RefineNet)."""
from ..config import NETS
from .refine_net import RefineNet

NETS.add("RefineNet", RefineNet)

__all__ = ["RefineNet"]
