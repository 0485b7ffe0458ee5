"""Host-side data for the trainer (the port of
``skycomputing_tpu/dataset``: generators, the GLUE dataset and its
preprocessing, CIFAR-10, synthetic datasets and the loader; numpy and
stdlib only)."""

from ..registry import DATASET
from . import glue
from .bert_dataset import GlueDataset
from .data_generator import (
    BaseGenerator,
    DataloaderGenerator,
    RandomTensorGenerator,
    RandomTokenGenerator,
)
from .dataloader import DataLoader
from .datasets import (
    CIFAR10Dataset,
    RandomBertDataset,
    RandomImageDataset,
    RandomLmDataset,
    RandomMlpDataset,
)

__all__ = [
    "BaseGenerator",
    "CIFAR10Dataset",
    "DATASET",
    "DataLoader",
    "DataloaderGenerator",
    "GlueDataset",
    "RandomBertDataset",
    "RandomImageDataset",
    "RandomLmDataset",
    "RandomMlpDataset",
    "RandomTensorGenerator",
    "RandomTokenGenerator",
    "glue",
]
