"""Model zoo of the port: the BERT pipeline units (slice 3) and the GPT
decode units (slices 1-2)."""

from .bert import (  # noqa: F401 - importing registers the layers
    BertEmbeddings,
    BertLayer_Body,
    BertLayer_BodyShard,
    BertLayer_Head,
    BertLayer_Tail,
    BertPooler,
    BertTailForClassification,
    bert_layer_configs,
    split_body_params,
)
from .bert_config import PRESETS, BertConfig, bert_config
from .gpt import (  # noqa: F401 - importing registers the layers
    GptBlock_Attn,
    GptBlock_Mlp,
    GptConfig,
    GptEmbeddings,
    GptLmHead,
    gpt_layer_configs,
)

__all__ = [
    "BertConfig",
    "BertEmbeddings",
    "BertLayer_Body",
    "BertLayer_BodyShard",
    "BertLayer_Head",
    "BertLayer_Tail",
    "BertPooler",
    "BertTailForClassification",
    "GptBlock_Attn",
    "GptBlock_Mlp",
    "GptConfig",
    "GptEmbeddings",
    "GptLmHead",
    "PRESETS",
    "bert_config",
    "bert_layer_configs",
    "gpt_layer_configs",
    "split_body_params",
]
