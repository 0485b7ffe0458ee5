"""BERT hyperparameter container (the port's own copy of
``skycomputing_tpu/models/bert_config.py``; stdlib only).

Constructible from kwargs, a dict, or a json file, with ``__dict__``
usable as a layer-config payload.  ``dtype`` selects the compute
precision (parameters stay float32; activations and matmuls run in
``dtype``, bfloat16 by default); ``use_flash_attention`` routes
attention through ``ops/flash_attention.py`` where ``models/bert.py``'s
condition holds.
"""

from __future__ import annotations

import json


class BertConfig:
    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        hidden_act: str = "gelu",
        hidden_dropout_prob: float = 0.1,
        attention_probs_dropout_prob: float = 0.1,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        initializer_range: float = 0.02,
        output_all_encoded_layers: bool = False,
        dtype: str = "bfloat16",
        use_flash_attention: bool = False,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.output_all_encoded_layers = output_all_encoded_layers
        self.dtype = dtype
        # fused attention (ops/flash_attention.py); only takes effect
        # when attention dropout is off or the module is deterministic
        self.use_flash_attention = use_flash_attention

    @classmethod
    def from_dict(cls, data) -> "BertConfig":
        if isinstance(data, BertConfig):
            return data
        cfg = cls()
        for k, v in dict(data).items():
            setattr(cfg, k, v)
        return cfg

    @classmethod
    def from_json_file(cls, path: str) -> "BertConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def __repr__(self) -> str:  # pragma: no cover
        return f"BertConfig({self.to_dict()})"


# Named presets (sizes follow the public BERT family; the reference
# experiment uses wwm_uncased_L-24_H-1024_A-16, i.e. "large").
PRESETS = {
    "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072),
    "large": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                  intermediate_size=4096),
    "tiny": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=512, vocab_size=1024, max_position_embeddings=128),
}


def bert_config(preset: str = "base", **overrides) -> BertConfig:
    kwargs = dict(PRESETS[preset])
    kwargs.update(overrides)
    return BertConfig(**kwargs)


__all__ = ["BertConfig", "bert_config", "PRESETS"]
