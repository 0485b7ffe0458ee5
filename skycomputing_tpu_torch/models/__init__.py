"""Model zoo of the port (slice 1: the GPT decode units)."""

from .gpt import (  # noqa: F401 - importing registers the layers
    GptBlock_Attn,
    GptBlock_Mlp,
    GptConfig,
    GptEmbeddings,
    GptLmHead,
    gpt_layer_configs,
)

__all__ = [
    "GptBlock_Attn",
    "GptBlock_Mlp",
    "GptConfig",
    "GptEmbeddings",
    "GptLmHead",
    "gpt_layer_configs",
]
