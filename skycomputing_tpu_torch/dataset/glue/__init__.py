"""GLUE preprocessing (the port's own copy of
``skycomputing_tpu/dataset/glue``; stdlib only)."""

from .processor import (
    PROCESSORS,
    ColaProcessor,
    DataProcessor,
    InputExample,
    InputFeatures,
    MnliProcessor,
    MrpcProcessor,
    Sst2Processor,
    convert_examples_to_features,
)
from .tokenization import (
    BasicTokenizer,
    BertTokenizer,
    WordpieceTokenizer,
    build_synthetic_vocab,
    load_vocab,
    train_wordpiece_vocab,
)

__all__ = [
    "PROCESSORS",
    "ColaProcessor",
    "DataProcessor",
    "InputExample",
    "InputFeatures",
    "MnliProcessor",
    "MrpcProcessor",
    "Sst2Processor",
    "convert_examples_to_features",
    "BasicTokenizer",
    "BertTokenizer",
    "WordpieceTokenizer",
    "build_synthetic_vocab",
    "load_vocab",
    "train_wordpiece_vocab",
]
