"""A minimal numpy DataLoader (the port's copy of
``skycomputing_tpu/dataset/dataloader.py``).

Data stays on the host as numpy until a train step moves each
microbatch to its stage's device — no worker processes.  Datasets are
map-style: ``__len__`` + ``__getitem__`` returning ``(inputs_tuple,
label)`` rows.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


def _stack(rows):
    """Stack a list of rows with matching nesting into batched arrays."""
    first = rows[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack([r[i] for r in rows]) for i in range(len(first)))
    return np.stack([np.asarray(r) for r in rows])


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 0,  # accepted for config parity; unused
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            rows = [self.dataset[int(i)] for i in idx]
            data = _stack([r[0] for r in rows])
            labels = np.asarray([r[1] for r in rows])
            yield data, labels


__all__ = ["DataLoader"]
