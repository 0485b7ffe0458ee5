"""Datasets (the port's numpy copy of
``skycomputing_tpu/dataset/datasets.py``): synthetic MLP features,
CIFAR-shaped images, MNLI-shaped BERT rows and causal-LM rows, and
CIFAR-10 from its binary distribution (or a seeded synthetic stand-in
where the files are missing)."""

from __future__ import annotations

import numpy as np

from ..registry import DATASET


@DATASET.register_module
class RandomMlpDataset:
    """Random-feature classification rows for MLP smoke tests."""

    def __init__(self, num_samples: int = 256, in_features: int = 32,
                 num_classes: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.features = rng.normal(
            size=(num_samples, in_features)).astype(np.float32)
        self.labels = rng.integers(0, num_classes, size=(num_samples,))

    def __len__(self):
        return len(self.features)

    def __getitem__(self, idx):
        return (self.features[idx],), int(self.labels[idx])


@DATASET.register_module
class RandomImageDataset:
    """CIFAR-shaped random images (an offline stand-in for CIFAR-10)."""

    def __init__(self, num_samples: int = 256, shape=(3, 32, 32),
                 num_classes: int = 10, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.normal(
            size=(num_samples, *shape)).astype(np.float32)
        self.labels = rng.integers(0, num_classes, size=(num_samples,))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return (self.images[idx],), int(self.labels[idx])


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


@DATASET.register_module
class CIFAR10Dataset:
    """CIFAR-10 from the local binary distribution: ``data_batch_*.bin``
    (``test_batch.bin`` with ``train=False``), 3,073-byte records of a
    label byte and 3,072 CHW pixel bytes, read with numpy, pixels scaled
    to [0, 1].  Without the files (or ``data_dir``) it is a seeded
    synthetic set of the same row shapes, the JAX dataset's arrays for
    the same arguments."""

    def __init__(self, data_dir: str = "", train: bool = True,
                 num_synthetic: int = 256, seed: int = 0):
        import glob
        import os

        pattern = "data_batch_*.bin" if train else "test_batch.bin"
        files = (sorted(glob.glob(os.path.join(data_dir, pattern)))
                 if data_dir else [])
        if files:
            records = np.concatenate([
                np.fromfile(f, dtype=np.uint8).reshape(-1, 3073)
                for f in files
            ])
            self.labels = records[:, 0].astype(np.int64)
            images = records[:, 1:].reshape(-1, 3, 32, 32)
            self.images = images.astype(np.float32) / 255.0
            self.synthetic = False
        else:
            if data_dir:
                from ..utils import Logger

                Logger().info(
                    f"CIFAR10Dataset: no {pattern} under {data_dir!r} - "
                    "using deterministic synthetic images (the binary "
                    "distribution unpacks into cifar-10-batches-bin/)"
                )
            rng = np.random.default_rng(seed)
            self.images = rng.random(
                (num_synthetic, 3, 32, 32)).astype(np.float32)
            self.labels = rng.integers(0, 10, size=(num_synthetic,))
            self.synthetic = True

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return (self.images[idx],), int(self.labels[idx])


@DATASET.register_module
class RandomLmDataset:
    """Synthetic causal-LM rows: ((input_ids,), input_ids).

    The labels are the input ids (the loss shifts them), each row an
    n-gram drawn from the seed and tiled to ``seq_length``, so a working
    LM visibly drives the loss toward zero."""

    def __init__(self, num_samples: int = 512, seq_length: int = 128,
                 vocab_size: int = 50257, ngram: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        reps = (seq_length + ngram - 1) // ngram
        rows = []
        for _ in range(num_samples):
            pattern = rng.integers(0, vocab_size, size=(ngram,),
                                   dtype=np.int32)
            rows.append(np.tile(pattern, reps)[:seq_length])
        self.input_ids = np.stack(rows)

    def __len__(self):
        return len(self.input_ids)

    def __getitem__(self, idx):
        row = self.input_ids[idx]
        return (row,), row


__all__ = ["CIFAR10Dataset", "RandomBertDataset", "RandomImageDataset",
           "RandomLmDataset", "RandomMlpDataset"]
