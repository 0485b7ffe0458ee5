"""BERT decomposed into pipeline-splittable units.

The port of ``skycomputing_tpu/models/bert.py``: the same registered
units, the same layer-config lists, the same numerics —

=========================  =============================================  =========================
registered name            inputs                                         outputs
=========================  =============================================  =========================
``BertEmbeddings``         (input_ids, token_type_ids, attention_mask)    (hidden, ext_mask)
``BertLayer_Head``         (hidden, ext_mask)                             (attn_out, ext_mask)
``BertLayer_Body``         (attn_out, ext_mask)                           (inter, attn_out, ext_mask)
``BertLayer_BodyShard``    shard 0 as Body; later shards (inter, ...)     (inter, attn_out, ext_mask)
``BertLayer_Tail``         (inter, attn_out, ext_mask)                    (hidden, ext_mask)
``BertPooler``             (hidden, ext_mask)                             pooled
``BertTailForClassification``  pooled                                     logits
=========================  =============================================  =========================

Numerics follow flax's ``dtype``/``param_dtype`` pair: parameters are
float32; dense layers cast input, kernel and bias to ``cfg.dtype``;
embeddings look up the table cast to ``cfg.dtype`` and sum word +
position + token type in it; LayerNorm runs in float32 with eps 1e-12
and its output is cast back; gelu is the exact (erf) form; the
classifier's logits come out in float32.  The additive mask
``(1 - mask) * -10000`` is computed once, in ``cfg.dtype`` (so -9984 in
bfloat16), and threaded through every layer.  With
``use_flash_attention`` (and attention dropout off or the module
deterministic, and L <= 128 or L % 128 == 0) attention goes through
``ops/flash_attention.py`` — the CUDA kernel on the card, its plain
version on the CPU; otherwise through the dense einsum path.

Each module's dense layers and embeddings carry ``init_std``, the
standard deviation of the flax initializer they mirror (``None``: flax
``Dense``'s default ``lecun_normal``), which
``dynamics/parameter_server.py`` reads to draw initial weights.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..registry import LAYER
from ..utils import torch_dtype
from .bert_config import BertConfig

# the exact, not the tanh, gelu
ACT2FN = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


class _Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``
    (flax ``Dense(dtype=..., param_dtype=float32)``).  ``init_std``: the
    N(0, std) kernel initializer, or ``None`` for ``lecun_normal``."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 init_std: Optional[float] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.init_std = init_std

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _embed(num: int, dim: int, init_std: float) -> nn.Embedding:
    """An embedding table drawn from N(0, init_std)."""
    table = nn.Embedding(num, dim)
    table.init_std = init_std
    return table


def _layer_norm(x, ln: nn.LayerNorm):
    """float32 LayerNorm with the module's eps (flax
    ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _cfg(config) -> BertConfig:
    return BertConfig.from_dict(config)


def _dense(cfg: BertConfig, n_in: int, n_out: int) -> _Dense:
    return _Dense(n_in, n_out, torch_dtype(cfg.dtype), cfg.initializer_range)


def _dropout(p: float, deterministic: bool) -> nn.Module:
    return nn.Identity() if deterministic or p == 0.0 else nn.Dropout(p)


@LAYER.register_module
class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings; also builds the additive
    mask ``(1 - mask) * -10000`` that every later layer receives."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        std = cfg.initializer_range
        self.word_embeddings = _embed(cfg.vocab_size, cfg.hidden_size, std)
        self.position_embeddings = _embed(cfg.max_position_embeddings,
                                          cfg.hidden_size, std)
        self.token_type_embeddings = _embed(cfg.type_vocab_size,
                                            cfg.hidden_size, std)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)
        self.dropout = _dropout(cfg.hidden_dropout_prob, deterministic)

    def forward(self, input_ids, token_type_ids, attention_mask):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        ext_mask = attention_mask[:, None, None, :].to(dt)
        ext_mask = (1.0 - ext_mask) * -10000.0

        seq_length = input_ids.shape[1]
        if seq_length > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq_length} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings}"
            )
        position_ids = torch.arange(seq_length,
                                    device=input_ids.device)[None, :]
        word = self.word_embeddings(input_ids.long()).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        tok = self.token_type_embeddings(token_type_ids.long()).to(dt)
        hidden = _layer_norm(word + pos + tok, self.LayerNorm).to(dt)
        return self.dropout(hidden), ext_mask


class BertSelfAttention(nn.Module):
    """Multi-head self-attention: the flash kernel where the JAX
    module's condition holds, else einsum scores and a float32
    softmax."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        if cfg.hidden_size % cfg.num_attention_heads != 0:
            raise ValueError(
                f"hidden size {cfg.hidden_size} not divisible by "
                f"{cfg.num_attention_heads} heads"
            )
        self.deterministic = deterministic
        H = cfg.hidden_size
        self.query = _dense(cfg, H, H)
        self.key = _dense(cfg, H, H)
        self.value = _dense(cfg, H, H)
        self.dropout = _dropout(cfg.attention_probs_dropout_prob,
                                deterministic)

    def uses_flash(self, seq_len: int) -> bool:
        cfg = self.config
        return (
            getattr(cfg, "use_flash_attention", False)
            and (cfg.attention_probs_dropout_prob == 0.0
                 or self.deterministic)
            # the TPU kernel tiles the sequence in 128-token blocks; the
            # einsum path takes the lengths it cannot tile
            and (seq_len <= 128 or seq_len % 128 == 0)
        )

    def forward(self, hidden_states, attention_mask):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        B, L = hidden_states.shape[:2]
        n_heads = cfg.num_attention_heads
        head_dim = cfg.hidden_size // n_heads

        def split_heads(x):
            return x.reshape(B, L, n_heads, head_dim)

        q = split_heads(self.query(hidden_states))
        k = split_heads(self.key(hidden_states))
        v = split_heads(self.value(hidden_states))

        if self.uses_flash(L):
            bias = attention_mask[:, 0, 0, :]
            context = flash_attention(q, k, v, bias)
            return context.reshape(B, L, cfg.hidden_size)

        scores = torch.einsum("blhd,bmhd->bhlm", q, k) / torch.sqrt(
            torch.tensor(head_dim, dtype=dt, device=q.device)
        )
        scores = scores + attention_mask
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        probs = self.dropout(probs)
        context = torch.einsum("bhlm,bmhd->blhd", probs, v)
        return context.reshape(B, L, cfg.hidden_size)


class BertSelfOutput(nn.Module):
    """Projection + residual + LayerNorm."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        self.dense = _dense(cfg, cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)
        self.dropout = _dropout(cfg.hidden_dropout_prob, deterministic)

    def forward(self, hidden_states, input_tensor):
        hidden_states = self.dropout(self.dense(hidden_states))
        out = _layer_norm(hidden_states + input_tensor, self.LayerNorm)
        return out.to(torch_dtype(self.config.dtype))


@LAYER.register_module
class BertLayer_Head(nn.Module):
    """Attention third of an encoder layer."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.self = BertSelfAttention(config, deterministic)
        self.output = BertSelfOutput(config, deterministic)

    def forward(self, hidden_states, attention_mask):
        self_out = self.self(hidden_states, attention_mask)
        return self.output(self_out, hidden_states), attention_mask


@LAYER.register_module
class BertLayer_Body(nn.Module):
    """Intermediate (FFN up-projection) third."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        self.dense_act = _dense(cfg, cfg.hidden_size, cfg.intermediate_size)

    def forward(self, attention_output, attention_mask):
        act = ACT2FN[self.config.hidden_act]
        inter = act(self.dense_act(attention_output))
        return inter, attention_output, attention_mask


@LAYER.register_module
class BertLayer_BodyShard(nn.Module):
    """A column slice of the FFN up-projection — finer allocation units.

    The activation applies elementwise, so the up-projection splits
    exactly by output columns: ``act(x @ W1) == concat_k act(x @ W1[:,
    k-th block])``.  ``num_shards`` of these units chained behind
    ``BertLayer_Head`` reproduce ``BertLayer_Body`` (the columns never
    mix).  Shard 0 consumes (attention_output, mask); later shards also
    thread the concatenated-so-far intermediate.  The last shard's
    outputs match ``BertLayer_Body``'s, so ``BertLayer_Tail`` follows
    unchanged; :func:`split_body_params` maps a body's weights onto the
    shards.
    """

    def __init__(self, config: Any, shard: int = 0, num_shards: int = 2,
                 deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        if cfg.intermediate_size % num_shards:
            raise ValueError(
                f"intermediate_size {cfg.intermediate_size} not divisible "
                f"by ffn shards {num_shards}"
            )
        self.shard = shard
        self.num_shards = num_shards
        self.dense_act = _dense(cfg, cfg.hidden_size,
                                cfg.intermediate_size // num_shards)

    def forward(self, *args):
        if self.shard == 0:
            attention_output, attention_mask = args
            inter_sofar = None
        else:
            inter_sofar, attention_output, attention_mask = args
        part = ACT2FN[self.config.hidden_act](
            self.dense_act(attention_output))
        inter = (part if inter_sofar is None
                 else torch.cat([inter_sofar, part], dim=-1))
        return inter, attention_output, attention_mask


def split_body_params(body_params: dict, num_shards: int) -> list:
    """A ``BertLayer_Body`` state dict -> one state dict per
    ``BertLayer_BodyShard``: row blocks of ``dense_act.weight`` ([out,
    in]) and ``dense_act.bias``, the exact inverse of concatenating the
    shards' outputs."""
    weight = body_params["dense_act.weight"]
    bias = body_params["dense_act.bias"]
    width = weight.shape[0] // num_shards
    return [
        {"dense_act.weight": weight[k * width:(k + 1) * width].clone(),
         "dense_act.bias": bias[k * width:(k + 1) * width].clone()}
        for k in range(num_shards)
    ]


@LAYER.register_module
class BertLayer_Tail(nn.Module):
    """FFN down-projection + residual third."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        self.dense = _dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)
        self.dropout = _dropout(cfg.hidden_dropout_prob, deterministic)

    def forward(self, intermediate_output, attention_output, attention_mask):
        hidden = self.dropout(self.dense(intermediate_output))
        out = _layer_norm(hidden + attention_output, self.LayerNorm)
        return out.to(torch_dtype(self.config.dtype)), attention_mask


@LAYER.register_module
class BertPooler(nn.Module):
    """First-token pooling + tanh projection."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = cfg = _cfg(config)
        self.dense_act = _dense(cfg, cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden_states, attention_mask):
        return torch.tanh(self.dense_act(hidden_states[:, 0]))


@LAYER.register_module
class BertTailForClassification(nn.Module):
    """Dropout + linear classifier head; float32 logits."""

    def __init__(self, hidden_dropout_prob: float, hidden_size: int,
                 num_classes: int, deterministic: bool = False,
                 dtype: str = "bfloat16"):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = _dropout(hidden_dropout_prob, deterministic)
        # flax Dense's default kernel initializer: lecun_normal
        self.classifier = _Dense(hidden_size, num_classes, torch_dtype(dtype))

    def forward(self, pooled):
        logits = self.classifier(self.dropout(pooled))
        return logits.reshape(-1, self.num_classes).float()


def bert_layer_configs(
    config: Any,
    num_encoder_units: int,
    num_classes: int = 3,
    deterministic: bool = False,
    ffn_shards: int = 1,
) -> list:
    """The layer-config list of a stacked BERT classifier: 1 embeddings
    + ``num_encoder_units`` x (head, body, tail) + pooler +
    classification tail, each entry a dict with ``layer_type`` + ctor
    kwargs — the same dicts the JAX package's ``bert_layer_configs``
    builds.  ``ffn_shards > 1`` replaces each ``BertLayer_Body`` with
    that many :class:`BertLayer_BodyShard` units."""
    cfg = _cfg(config)
    # fresh dicts per entry: allocators may tag layer configs in place
    if ffn_shards > 1:
        def body_units():
            return [
                dict(layer_type="BertLayer_BodyShard", config=cfg.to_dict(),
                     shard=k, num_shards=ffn_shards,
                     deterministic=deterministic)
                for k in range(ffn_shards)
            ]
    else:
        def body_units():
            return [dict(layer_type="BertLayer_Body", config=cfg.to_dict(),
                         deterministic=deterministic)]
    encoder = [
        unit
        for _ in range(num_encoder_units)
        for unit in (
            [dict(layer_type="BertLayer_Head", config=cfg.to_dict(),
                  deterministic=deterministic)]
            + body_units()
            + [dict(layer_type="BertLayer_Tail", config=cfg.to_dict(),
                    deterministic=deterministic)]
        )
    ]
    return (
        [dict(layer_type="BertEmbeddings", config=cfg.to_dict(),
              deterministic=deterministic)]
        + encoder
        + [
            dict(layer_type="BertPooler", config=cfg.to_dict(),
                 deterministic=deterministic),
            dict(
                layer_type="BertTailForClassification",
                hidden_dropout_prob=cfg.hidden_dropout_prob,
                hidden_size=cfg.hidden_size,
                num_classes=num_classes,
                deterministic=deterministic,
                dtype=cfg.dtype,
            ),
        ]
    )


__all__ = [
    "ACT2FN",
    "BertEmbeddings",
    "BertSelfAttention",
    "BertSelfOutput",
    "BertLayer_Head",
    "BertLayer_Body",
    "BertLayer_BodyShard",
    "split_body_params",
    "BertLayer_Tail",
    "BertPooler",
    "BertTailForClassification",
    "bert_layer_configs",
]
