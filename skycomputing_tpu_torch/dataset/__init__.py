"""Host-side data for the trainer (the port of
``skycomputing_tpu/dataset``'s generators, synthetic BERT dataset and
loader; numpy only)."""

from ..registry import DATASET
from .data_generator import (
    BaseGenerator,
    DataloaderGenerator,
    RandomTensorGenerator,
    RandomTokenGenerator,
)
from .dataloader import DataLoader
from .datasets import RandomBertDataset

__all__ = [
    "BaseGenerator",
    "DATASET",
    "DataLoader",
    "DataloaderGenerator",
    "RandomBertDataset",
    "RandomTensorGenerator",
    "RandomTokenGenerator",
]
