"""Host-side data for the trainer (the port of
``skycomputing_tpu/dataset``'s generators and loader; numpy only)."""

from .data_generator import BaseGenerator, RandomTokenGenerator
from .dataloader import DataLoader

__all__ = ["BaseGenerator", "DataLoader", "RandomTokenGenerator"]
