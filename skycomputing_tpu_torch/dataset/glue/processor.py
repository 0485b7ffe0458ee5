"""GLUE task processors and example -> feature conversion (the port's
own copy of ``skycomputing_tpu/dataset/glue/processor.py``; stdlib only).

TSV readers per task (MRPC, MNLI, CoLA, SST-2), ``[CLS] a [SEP] b
[SEP]`` packing with segment ids, attention masks, and zero padding to
``max_seq_length``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class InputExample:
    guid: str
    text_a: str
    text_b: Optional[str] = None
    label: Optional[str] = None


@dataclass
class InputFeatures:
    input_ids: List[int]
    input_mask: List[int]
    segment_ids: List[int]
    label_id: int


def read_tsv(path: str, quotechar: Optional[str] = None) -> List[List[str]]:
    with open(path, encoding="utf-8") as fh:
        return [
            line
            for line in csv.reader(fh, delimiter="\t", quotechar=quotechar)
        ]


class DataProcessor:
    """Base class: one GLUE task's file layout and label set."""

    def get_train_examples(self, data_dir: str) -> List[InputExample]:
        raise NotImplementedError

    def get_dev_examples(self, data_dir: str) -> List[InputExample]:
        raise NotImplementedError

    def get_labels(self) -> List[str]:
        raise NotImplementedError


class MrpcProcessor(DataProcessor):
    def get_train_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "train.tsv")), "train")

    def get_dev_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "dev.tsv")), "dev")

    def get_labels(self):
        return ["0", "1"]

    @staticmethod
    def _examples(lines, set_type):
        examples = []
        for i, line in enumerate(lines):
            if i == 0:
                continue
            examples.append(
                InputExample(
                    guid=f"{set_type}-{i}",
                    text_a=line[3],
                    text_b=line[4],
                    label=line[0],
                )
            )
        return examples


class MnliProcessor(DataProcessor):
    def get_train_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "train.tsv")), "train")

    def get_dev_examples(self, data_dir):
        return self._examples(
            read_tsv(os.path.join(data_dir, "dev_matched.tsv")), "dev_matched"
        )

    def get_labels(self):
        return ["contradiction", "entailment", "neutral"]

    @staticmethod
    def _examples(lines, set_type):
        examples = []
        for i, line in enumerate(lines):
            if i == 0:
                continue
            examples.append(
                InputExample(
                    guid=f"{set_type}-{line[0]}",
                    text_a=line[8],
                    text_b=line[9],
                    label=line[-1],
                )
            )
        return examples


class ColaProcessor(DataProcessor):
    def get_train_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "train.tsv")), "train")

    def get_dev_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "dev.tsv")), "dev")

    def get_labels(self):
        return ["0", "1"]

    @staticmethod
    def _examples(lines, set_type):
        return [
            InputExample(guid=f"{set_type}-{i}", text_a=line[3], label=line[1])
            for i, line in enumerate(lines)
        ]


class Sst2Processor(DataProcessor):
    def get_train_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "train.tsv")), "train")

    def get_dev_examples(self, data_dir):
        return self._examples(read_tsv(os.path.join(data_dir, "dev.tsv")), "dev")

    def get_labels(self):
        return ["0", "1"]

    @staticmethod
    def _examples(lines, set_type):
        examples = []
        for i, line in enumerate(lines):
            if i == 0:
                continue
            examples.append(
                InputExample(guid=f"{set_type}-{i}", text_a=line[0], label=line[1])
            )
        return examples


PROCESSORS: Dict[str, type] = {
    "mrpc": MrpcProcessor,
    "mnli": MnliProcessor,
    "cola": ColaProcessor,
    "sst-2": Sst2Processor,
}


def truncate_seq_pair(tokens_a: List[str], tokens_b: List[str], max_length: int):
    """Trim the longer of the pair until the combined length fits."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def convert_examples_to_features(
    examples: Sequence[InputExample],
    label_list: Sequence[str],
    max_seq_length: int,
    tokenizer,
) -> Tuple[List[InputFeatures], Dict[str, int]]:
    """Tokenize/pack/pad examples into fixed-length feature rows."""
    label_map = {label: i for i, label in enumerate(label_list)}
    features = []
    for example in examples:
        tokens_a = tokenizer.tokenize(example.text_a)
        tokens_b = tokenizer.tokenize(example.text_b) if example.text_b else None

        if tokens_b is not None:
            truncate_seq_pair(tokens_a, tokens_b, max_seq_length - 3)
        else:
            tokens_a = tokens_a[: max_seq_length - 2]

        tokens = ["[CLS]"] + tokens_a + ["[SEP]"]
        segment_ids = [0] * len(tokens)
        if tokens_b is not None:
            tokens += tokens_b + ["[SEP]"]
            segment_ids += [1] * (len(tokens_b) + 1)

        input_ids = tokenizer.convert_tokens_to_ids(tokens)
        input_mask = [1] * len(input_ids)

        pad = [0] * (max_seq_length - len(input_ids))
        input_ids += pad
        input_mask += pad
        segment_ids += pad

        features.append(
            InputFeatures(
                input_ids=input_ids,
                input_mask=input_mask,
                segment_ids=segment_ids,
                label_id=label_map[example.label],
            )
        )
    return features, label_map


__all__ = [
    "InputExample",
    "InputFeatures",
    "DataProcessor",
    "MrpcProcessor",
    "MnliProcessor",
    "ColaProcessor",
    "Sst2Processor",
    "PROCESSORS",
    "convert_examples_to_features",
    "truncate_seq_pair",
    "read_tsv",
]
