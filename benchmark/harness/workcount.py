"""Operations and bytes that the work needs, from shapes and lengths.

The yardstick of every roofline and MFU metric: counted from the cell's
shapes and the harness's own record of its inputs, never from the
program's counters, so a count reads the same whatever implements the
work.  A multiply-add is two operations.  Model FLOPs count no
recomputation.  A kernel's bytes count each input byte read once and
each output byte written once, over the positions its inputs need (real
tokens, live context), whatever the kernel reads again or pads.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple


# --- BERT --------------------------------------------------------------------

def bert_encoder_matmul_params(cfg: dict) -> int:
    """Weights of the dense products of the encoder layers."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (4 * H * H + 2 * H * I)


def bert_step_flops(cfg: dict, batch: int, seq: int, num_classes: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recomputation) over the padded batch: 6 x encoder weights x positions,
    the pooler and classifier once a row, and 12 x layers x positions x
    seq x hidden for the attention products."""
    H = cfg["hidden_size"]
    positions = batch * seq
    dense = 6 * bert_encoder_matmul_params(cfg) * positions
    head = 6 * (H * H + H * num_classes) * batch
    attention = 12 * cfg["num_hidden_layers"] * positions * seq * H
    return float(dense + head + attention)


def b1_call_need(lengths: Sequence[int], heads: int, head_dim: int,
                 itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) that one call of the non-causal attention
    forward needs over rows of these real lengths: Q K^T and P V over the
    real keys of each real query; q, k, v and the key bias of the real
    positions read once, o written once."""
    flops = sum(4 * heads * head_dim * n * n for n in lengths)
    nbytes = sum(4 * n * heads * head_dim * itemsize + n * itemsize
                 for n in lengths)
    return float(flops), float(nbytes)


# --- GPT serving ---------------------------------------------------------------

def gpt_block_matmul_params(cfg: dict) -> int:
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (4 * H * H + 2 * H * I)


def gpt_head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def gpt_prefill_flops(cfg: dict, start: int, n: int) -> float:
    """Model FLOPs of prefilling ``n`` prompt positions after ``start``
    cached ones and producing the first token: the blocks' products for
    each position, the LM head once, and causal attention (4 x hidden
    operations per visible position per layer)."""
    H, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    attention = 4 * H * layers * (n * start + n * (n + 1) // 2)
    return float(2 * gpt_block_matmul_params(cfg) * n
                 + 2 * gpt_head_params(cfg) + attention)


def gpt_decode_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one decoded token whose position sees ``context``
    positions (itself included)."""
    H, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    return float(2 * (gpt_block_matmul_params(cfg) + gpt_head_params(cfg))
                 + 4 * H * layers * context)


def b2_decode_need(contexts: Iterable[int], hidden: int,
                   itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one layer's paged-attention call over decode
    rows that see these live contexts: each row's K and V pages of its
    live positions read once, its q read and its o written."""
    flops = nbytes = 0
    for c in contexts:
        flops += 4 * hidden * c
        nbytes += (2 * c + 2) * hidden * itemsize
    return float(flops), float(nbytes)


def b2_prefill_need(rows: Iterable[Tuple[int, int]], hidden: int,
                    itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one layer's paged-attention call over prefill
    rows ``(start, n)``: ``n`` causal queries after ``start`` cached
    positions; K and V of the ``start + n`` visible positions read once,
    q read and o written for the ``n`` new ones."""
    flops = nbytes = 0
    for start, n in rows:
        flops += 4 * hidden * (n * start + n * (n + 1) // 2)
        nbytes += (2 * (start + n) + 2 * n) * hidden * itemsize
    return float(flops), float(nbytes)
