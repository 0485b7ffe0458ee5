"""GLUE fine-tuning dataset (the port's copy of
``skycomputing_tpu/dataset/bert_dataset.py``; numpy and stdlib only).

Tokenizes a GLUE task's TSVs into ``InputFeatures`` and caches their
four arrays as ``*.features.npz`` (no pickle) beside the data or in
``cache_dir``; ``__getitem__`` returns
``((input_ids, input_mask, segment_ids), label)``.  Where ``data_dir`` or
``vocab_file`` is missing, the dataset is a seeded, class-conditional
synthetic corpus with the same row shapes: the same arrays as the JAX
package's from the same seeds.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..registry import DATASET
from ..utils import Logger
from .glue import (
    PROCESSORS,
    BertTokenizer,
    build_synthetic_vocab,
    convert_examples_to_features,
)

_FEATURE_ARRAYS = ("input_ids", "input_mask", "segment_ids", "labels")


@DATASET.register_module
class GlueDataset:
    def __init__(
        self,
        data_dir: str,
        vocab_file: Optional[str] = None,
        max_seq_length: int = 128,
        do_lower_case: bool = False,
        processor: str = "mnli",
        split: str = "train",
        bert_model: str = "large-uncased",  # accepted for config parity
        cache_dir: Optional[str] = None,
        synthetic_num_samples: int = 512,
    ):
        self.max_seq_length = max_seq_length
        proc_cls = PROCESSORS[processor.lower()]
        self.processor = proc_cls()
        self.label_list = self.processor.get_labels()
        logger = Logger()

        have_data = bool(data_dir) and os.path.isdir(data_dir)
        have_vocab = bool(vocab_file) and os.path.isfile(vocab_file)

        if have_data and have_vocab:
            cache_dir = cache_dir or data_dir
            vocab_tag = os.path.basename(vocab_file)
            # the JAX package's cache beside it is a pickle of its own
            # feature classes, which would import that package here; the
            # port caches the four arrays instead, without pickle
            cache_file = os.path.join(
                cache_dir,
                f"{processor}_{split}_{max_seq_length}_{do_lower_case}_"
                f"{vocab_tag}.features.npz",
            )
            if os.path.isfile(cache_file):
                with np.load(cache_file, allow_pickle=False) as cached:
                    arrays = {k: cached[k] for k in _FEATURE_ARRAYS}
            else:
                tokenizer = BertTokenizer(
                    vocab_file=vocab_file, do_lower_case=do_lower_case
                )
                if split == "train":
                    examples = self.processor.get_train_examples(data_dir)
                else:
                    examples = self.processor.get_dev_examples(data_dir)
                features, _ = convert_examples_to_features(
                    examples, self.label_list, max_seq_length, tokenizer
                )
                rows = (-1, max_seq_length)
                arrays = dict(
                    input_ids=np.asarray([f.input_ids for f in features],
                                         dtype=np.int32).reshape(rows),
                    input_mask=np.asarray([f.input_mask for f in features],
                                          dtype=np.int32).reshape(rows),
                    segment_ids=np.asarray([f.segment_ids for f in features],
                                           dtype=np.int32).reshape(rows),
                    labels=np.asarray([f.label_id for f in features],
                                      dtype=np.int32),
                )
                try:
                    with open(cache_file, "wb") as fh:
                        np.savez(fh, **arrays)
                except OSError:  # read-only data dir: skip caching
                    pass
            self.input_ids = arrays["input_ids"]
            self.input_mask = arrays["input_mask"]
            self.segment_ids = arrays["segment_ids"]
            self.labels = arrays["labels"]
            self.synthetic = False
        else:
            logger.info(
                f"GlueDataset: data_dir={data_dir!r} or vocab_file={vocab_file!r} "
                "unavailable — using deterministic synthetic corpus"
            )
            vocab = build_synthetic_vocab()
            # distinct corpora per split so eval never scores training rows
            rng = np.random.default_rng(11 + sum(ord(c) for c in split))
            n = synthetic_num_samples
            # LEARNABLE corpus, not label noise: labels drawn first, then
            # each row's tokens drawn from a class-conditional band of the
            # vocabulary (bands overlap ~30% so the task is non-trivial
            # but separable).  With uniform random labels a classifier can
            # never beat ln(num_classes), so loss curves on the synthetic
            # fallback could only prove execution (flat at ~1.10 for 3
            # classes).  Class signal makes "loss falls" a real statement
            # about training.
            num_classes = len(self.label_list)
            self.labels = rng.integers(
                0, num_classes, size=(n,)
            ).astype(np.int32)
            usable = len(vocab) - 5
            band = int(usable / (0.7 * num_classes + 0.3))
            starts = 5 + (
                np.arange(num_classes) * int(0.7 * band)
            ).astype(np.int64)
            lo = starts[self.labels][:, None]
            self.input_ids = (
                lo + rng.integers(0, band, size=(n, max_seq_length))
            ).clip(max=len(vocab) - 1).astype(np.int32)
            lengths = rng.integers(8, max_seq_length + 1, size=(n,))
            self.input_mask = (
                np.arange(max_seq_length)[None, :] < lengths[:, None]
            ).astype(np.int32)
            self.input_ids *= self.input_mask
            seg = rng.integers(1, max_seq_length, size=(n,))
            self.segment_ids = (
                np.arange(max_seq_length)[None, :] >= seg[:, None]
            ).astype(np.int32) * self.input_mask
            self.synthetic = True

    def __len__(self):
        return len(self.input_ids)

    def __getitem__(self, idx):
        return (
            (self.input_ids[idx], self.input_mask[idx], self.segment_ids[idx]),
            int(self.labels[idx]),
        )


__all__ = ["GlueDataset"]
