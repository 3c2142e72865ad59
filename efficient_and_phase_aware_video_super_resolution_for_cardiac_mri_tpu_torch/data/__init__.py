from . import datasets, transforms
from .datasets import BaseDataset, MISRDataset, SISRDataset, VSRDataset, VSRRefineNetDataset
from .loader import Dataloader, default_collate
from .transforms import compose

__all__ = [
    "datasets",
    "transforms",
    "BaseDataset",
    "MISRDataset",
    "SISRDataset",
    "VSRDataset",
    "VSRRefineNetDataset",
    "Dataloader",
    "default_collate",
    "compose",
]
