"""Synthetic datasets (the port's numpy copy of
``skycomputing_tpu/dataset/datasets.py``: the BERT dataset the
launcher's config trains on; the others and ``GlueDataset`` are not
ported)."""

from __future__ import annotations

import numpy as np

from ..registry import DATASET


@DATASET.register_module
class RandomBertDataset:
    """Synthetic MNLI-shaped rows: ((input_ids, mask, segment_ids), label),
    with padded tails (lengths drawn in [8, max_seq_length]), so the
    attention bias masks keys."""

    def __init__(self, num_samples: int = 512, max_seq_length: int = 128,
                 vocab_size: int = 30522, num_classes: int = 3, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.input_ids = rng.integers(
            5, vocab_size, size=(num_samples, max_seq_length), dtype=np.int32
        )
        lengths = rng.integers(8, max_seq_length + 1, size=(num_samples,))
        self.input_mask = (
            np.arange(max_seq_length)[None, :] < lengths[:, None]
        ).astype(np.int32)
        self.input_ids *= self.input_mask
        seg_split = rng.integers(1, max_seq_length, size=(num_samples,))
        self.segment_ids = (
            np.arange(max_seq_length)[None, :] >= seg_split[:, None]
        ).astype(np.int32) * self.input_mask
        self.labels = rng.integers(0, num_classes, size=(num_samples,))

    def __len__(self):
        return len(self.input_ids)

    def __getitem__(self, idx):
        return (
            (self.input_ids[idx], self.input_mask[idx], self.segment_ids[idx]),
            int(self.labels[idx]),
        )


__all__ = ["RandomBertDataset"]
