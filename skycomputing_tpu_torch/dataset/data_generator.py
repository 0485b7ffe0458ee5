"""Benchmark-input generators (the port's numpy copy of
``skycomputing_tpu/dataset/data_generator.py``): a random tensor for
the device benchmark, BERT-shaped tokens for the model benchmark, and
probe batches drawn from a dataloader config (by default the first
batch, always)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..registry import DATA_GENERATOR


class BaseGenerator:
    def generate(self):
        raise NotImplementedError


@DATA_GENERATOR.register_module
class RandomTensorGenerator(BaseGenerator):
    """A random float tensor of a configured size (device-benchmark probe)."""

    def __init__(self, size: Sequence[int], dtype: str = "float32",
                 seed: int = 0):
        self.size = tuple(size)
        self.dtype = dtype
        self._rng = np.random.default_rng(seed)

    def generate(self):
        return self._rng.normal(size=self.size).astype(self.dtype)


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


@DATA_GENERATOR.register_module
class DataloaderGenerator(BaseGenerator):
    """Probe batches from a dataloader config: with ``fixed`` the first
    batch every time, else the batches in turn, starting over at the
    end."""

    def __init__(self, generator_cfg: dict, fixed: bool = True):
        from ..builder import build_dataloader_from_cfg

        self._dataloader = build_dataloader_from_cfg(generator_cfg)
        self._fixed = fixed
        self._iter = None
        self._first = None

    def generate(self):
        if self._fixed:
            if self._first is None:
                self._first = self._next_batch()[0]
            return self._first
        try:
            if self._iter is None:
                self._iter = iter(self._dataloader)
            batch = next(self._iter)
        except StopIteration:
            self._iter = None
            batch = self._next_batch()
        return batch[0]

    def _next_batch(self):
        try:
            return next(iter(self._dataloader))
        except StopIteration:
            raise ValueError(
                "DataloaderGenerator: underlying dataloader yields no batches "
                "(dataset smaller than batch_size with drop_last=True?)"
            ) from None


__all__ = [
    "BaseGenerator",
    "DataloaderGenerator",
    "RandomTensorGenerator",
    "RandomTokenGenerator",
]
