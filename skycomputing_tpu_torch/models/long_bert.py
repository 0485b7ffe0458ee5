"""Long-context BERT units (the port of
``skycomputing_tpu/models/long_bert.py``).

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

With a ``mesh`` (:mod:`..parallel.mesh`, a 1-d mesh over
``axis_name``) the sequence is sharded over the mesh's positions, as in
JAX: ``strategy="ring"`` takes ``parallel/ring_attention.ring_attention``
and ``"ulysses"`` ``parallel/ulysses.ulysses_attention``; any other
strategy raises ``ValueError`` at the first forward.  On ``meta`` (the
static profile, the pre-flight) a mesh-built head runs one position's
program over its L/S rows (:func:`..parallel.mesh.one_position`), the
share of the work XLA's cost analysis charges the JAX head's sharded
program.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from ..ops.flash_attention import flash_attention
from ..registry import LAYER
from ..utils import torch_dtype
from .bert import BertSelfOutput, _cfg, _dense


class LongBertSelfAttention(nn.Module):
    """Multi-head self-attention: sequence-parallel over ``mesh``, else
    through the flash kernel or the float32 einsum reference."""

    def __init__(self, config: Any, deterministic: bool = False,
                 mesh: Any = None, axis_name: str = "sp",
                 strategy: str = "ring", use_flash: bool = True):
        super().__init__()
        self.config = cfg = _cfg(config)
        self.deterministic = deterministic
        self.mesh = mesh
        self.axis_name = axis_name
        self.strategy = strategy
        self.use_flash = use_flash
        H = cfg.hidden_size
        self.query = _dense(cfg, H, H)
        self.key = _dense(cfg, H, H)
        self.value = _dense(cfg, H, H)

    def _qkv(self, hidden_states):
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
        return tuple(dense(hidden_states).reshape(B, L, n_heads, head_dim)
                     for dense in (self.query, self.key, self.value))

    def _merge(self, context):
        cfg = self.config
        return context.reshape(*context.shape[:2], cfg.hidden_size).to(
            torch_dtype(cfg.dtype))

    def check_mesh(self, L: int, S: int) -> None:
        """Raise where ``strategy`` cannot split a sequence of ``L`` over
        S positions, or is unknown."""
        from ..parallel.ring_attention import check_ring
        from ..parallel.ulysses import check_ulysses

        if self.strategy == "ulysses":
            check_ulysses(L, self.config.num_attention_heads, S,
                          self.axis_name)
        elif self.strategy == "ring":
            check_ring(L, S, self.axis_name)
        else:
            raise ValueError(
                f"unknown sequence-parallel strategy {self.strategy!r}"
            )

    def position_forward(self, rows, attention_mask, S: int):
        """Position 0's program of the sequence-parallel attention on
        ``meta``: ``rows`` its L/S rows, ``attention_mask`` the whole
        mask."""
        from ..parallel.ring_attention import ring_position
        from ..parallel.ulysses import ulysses_position

        q, k, v = self._qkv(rows)
        bias = attention_mask[:, 0, 0, :]
        if self.strategy == "ulysses":
            context = ulysses_position(q, k, v, S, bias=bias)
        else:
            context = ring_position(q, k, v,
                                    bias_blk=bias[:, :rows.shape[1]])
        return self._merge(context)

    def forward(self, hidden_states, attention_mask):
        q, k, v = self._qkv(hidden_states)
        bias = attention_mask[:, 0, 0, :]
        # the parallel modules are imported here: the parallel package
        # imports the pipeline, which imports the model zoo
        if self.mesh is not None:
            if self.strategy == "ulysses":
                from ..parallel.ulysses import ulysses_attention

                context = ulysses_attention(
                    q, k, v, self.mesh, axis_name=self.axis_name, bias=bias)
            elif self.strategy == "ring":
                from ..parallel.ring_attention import ring_attention

                context = ring_attention(
                    q, k, v, self.mesh, axis_name=self.axis_name, bias=bias)
            else:
                raise ValueError(
                    f"unknown sequence-parallel strategy {self.strategy!r}"
                )
        elif self.use_flash:
            context = flash_attention(q, k, v, bias)
        else:
            from ..parallel.ring_attention import full_attention_reference

            context = full_attention_reference(q, k, v, bias=bias)
        return self._merge(context)


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
        attn = self.self
        if attn.mesh is not None and hidden_states.device.type == "meta":
            from ..parallel.mesh import one_position

            S = len(attn.mesh.ring(attn.axis_name, hidden_states))
            attn.check_mesh(hidden_states.shape[1], S)
            out = one_position(
                lambda rows, mask: self.output(
                    attn.position_forward(rows, mask, S), rows),
                S, hidden_states, attention_mask)
            return out, attention_mask
        self_out = attn(hidden_states, attention_mask)
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
