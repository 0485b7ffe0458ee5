"""Long-context BERT units (the port of
``skycomputing_tpu/models/long_bert.py``), on one device.

``LongBertLayer_Head`` is a drop-in for ``BertLayer_Head``: the same
parameters (``self.query/key/value``, ``output.dense`` /
``output.LayerNorm``), so a ``BertLayer_Head`` state dict loads into it
unchanged.  Its attention turns BERT's extended mask ``[B, 1, 1, L]``
into a per-key bias ``[B, L]`` and takes, with ``use_flash=True`` (the
default), ``ops/flash_attention.flash_attention``: the CUDA kernel on
the card, its plain version on the CPU and on ``meta``; with
``use_flash=False`` the float32 einsum path
(``parallel/ring_attention.full_attention_reference``).  Neither
materializes attention probabilities it could drop, so training with
``attention_probs_dropout_prob > 0`` raises, as in JAX.

The JAX module shards the sequence over a mesh axis (ring attention or
Ulysses).  That needs ``torch.distributed`` and is queue A item 2c: a
``mesh``, or a ``strategy`` other than ``"ring"``, raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from ..ops.flash_attention import flash_attention
from ..registry import LAYER
from ..utils import torch_dtype
from .bert import BertSelfOutput, _cfg, _dense


def _single_device_only(mesh, strategy: str) -> None:
    if mesh is not None or strategy != "ring":
        raise NotImplementedError(
            "sequence-parallel long BERT (mesh=, strategy=) is not ported "
            "to PyTorch yet (queue A item 2c: ring attention and Ulysses "
            "over torch.distributed)")


class LongBertSelfAttention(nn.Module):
    """Multi-head self-attention through the flash kernel or the
    float32 einsum reference."""

    def __init__(self, config: Any, deterministic: bool = False,
                 mesh: Any = None, axis_name: str = "sp",
                 strategy: str = "ring", use_flash: bool = True):
        super().__init__()
        _single_device_only(mesh, strategy)
        self.config = cfg = _cfg(config)
        self.deterministic = deterministic
        self.use_flash = use_flash
        H = cfg.hidden_size
        self.query = _dense(cfg, H, H)
        self.key = _dense(cfg, H, H)
        self.value = _dense(cfg, H, H)

    def forward(self, hidden_states, attention_mask):
        cfg = self.config
        if (cfg.attention_probs_dropout_prob > 0 and self.training
                and not self.deterministic):
            raise ValueError(
                "LongBertSelfAttention does not support attention-probs "
                "dropout; set attention_probs_dropout_prob=0 or "
                "deterministic=True"
            )
        B, L = hidden_states.shape[:2]
        n_heads = cfg.num_attention_heads
        head_dim = cfg.hidden_size // n_heads

        def split_heads(x):
            return x.reshape(B, L, n_heads, head_dim)

        q = split_heads(self.query(hidden_states))
        k = split_heads(self.key(hidden_states))
        v = split_heads(self.value(hidden_states))
        bias = attention_mask[:, 0, 0, :]
        if self.use_flash:
            context = flash_attention(q, k, v, bias)
        else:
            # imported here: the parallel package imports the pipeline,
            # which imports the model zoo
            from ..parallel.ring_attention import full_attention_reference

            context = full_attention_reference(q, k, v, bias=bias)
        return context.reshape(B, L, cfg.hidden_size).to(
            torch_dtype(cfg.dtype))


@LAYER.register_module
class LongBertLayer_Head(nn.Module):
    """Attention third of an encoder layer for long sequences."""

    def __init__(self, config: Any, deterministic: bool = False,
                 mesh: Any = None, axis_name: str = "sp",
                 strategy: str = "ring", use_flash: bool = True):
        super().__init__()
        self.self = LongBertSelfAttention(config, deterministic, mesh,
                                          axis_name, strategy, use_flash)
        self.output = BertSelfOutput(config, deterministic)

    def forward(self, hidden_states, attention_mask):
        self_out = self.self(hidden_states, attention_mask)
        return self.output(self_out, hidden_states), attention_mask


def long_bert_layer_configs(config: Any, num_encoder_units: int,
                            mesh: Any = None, num_classes: int = 3,
                            deterministic: bool = False,
                            axis_name: str = "sp",
                            strategy: str = "ring") -> list:
    """The JAX package's layer-config list with long heads: embeddings,
    ``num_encoder_units`` x (``LongBertLayer_Head``, body, tail), pooler
    and classifier, dict for dict."""
    cfg = _cfg(config)
    encoder = []
    for _ in range(num_encoder_units):
        encoder.append(
            dict(layer_type="LongBertLayer_Head", config=cfg.to_dict(),
                 deterministic=deterministic, mesh=mesh,
                 axis_name=axis_name, strategy=strategy))
        encoder.append(
            dict(layer_type="BertLayer_Body", config=cfg.to_dict(),
                 deterministic=deterministic))
        encoder.append(
            dict(layer_type="BertLayer_Tail", config=cfg.to_dict(),
                 deterministic=deterministic))
    return (
        [dict(layer_type="BertEmbeddings", config=cfg.to_dict(),
              deterministic=deterministic)]
        + encoder
        + [
            dict(layer_type="BertPooler", config=cfg.to_dict(),
                 deterministic=deterministic),
            dict(layer_type="BertTailForClassification",
                 hidden_dropout_prob=cfg.hidden_dropout_prob,
                 hidden_size=cfg.hidden_size, num_classes=num_classes,
                 deterministic=deterministic, dtype=cfg.dtype),
        ]
    )


__all__ = ["LongBertLayer_Head", "LongBertSelfAttention",
           "long_bert_layer_configs"]
