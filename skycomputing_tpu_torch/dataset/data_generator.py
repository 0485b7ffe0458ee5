"""Benchmark-input generators (the port's numpy copy of
``skycomputing_tpu/dataset/data_generator.py``: the BERT token
generator; the tensor and dataloader-backed generators are not
ported)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..registry import DATA_GENERATOR


class BaseGenerator:
    def generate(self):
        raise NotImplementedError


@DATA_GENERATOR.register_module
class RandomTokenGenerator(BaseGenerator):
    """BERT-shaped probe inputs: (input_ids, token_type_ids, attention_mask)."""

    def __init__(self, batch_size: int = 32, seq_length: int = 128,
                 vocab_size: int = 30522, seed: int = 0):
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)

    def generate(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids = self._rng.integers(
            5, self.vocab_size, size=(self.batch_size, self.seq_length),
            dtype=np.int32,
        )
        types = np.zeros_like(ids)
        mask = np.ones_like(ids)
        return ids, types, mask


__all__ = ["BaseGenerator", "RandomTokenGenerator"]
