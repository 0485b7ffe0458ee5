"""Compiled SPMD pipeline for the GPT family (the port of
``skycomputing_tpu/parallel/spmd_gpt.py``).

Reuses :class:`~.spmd.CompiledBertPipeline`'s schedules, layouts,
tensor parallelism, ZeRO and train step with GPT's ends: token
embeddings in, LM head out, the causal-LM loss.  The pipelined stage
flows ``(hidden, side)``: the causal mask is rebuilt inside each block,
so the side tensor is a zero placeholder for dense stages and, for MoE
stages (``GptMoeEncoderStage`` with ``side_outputs``), the Switch
load-balance aux-loss accumulator, which travels with its microbatch
around the ring.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..models.gpt import (
    ACT2FN,
    GptBlock_Attn,
    GptBlock_Mlp,
    GptBlock_MoeMlp,
    GptConfig,
    GptEmbeddings,
    GptLmHead,
)
from ..ops.losses import causal_lm_loss
from ..ops.moe import expert_mlp, moe_combine, moe_dispatch, moe_route
from ..utils import torch_dtype
from .spmd import (
    CompiledBertPipeline,
    TpEncoderStage,
    _RematStage,
    _as_tensor,
    _call,
    _check_tp,
    _tp_dense,
    _tp_layer_norm,
    dropout,
    fold_seed,
    seeded,
)
from .sharded import psum

# GPT dense modules by Megatron role: q/k/v and the FFN up-projection are
# column-parallel; attention-out and FFN-down (both ``c_proj``) row-parallel
GPT_TP_COL = ("q_proj", "k_proj", "v_proj", "c_fc")
GPT_TP_ROW = ("c_proj",)

# MoE expert tensors as (module, param) pairs: w1/b1 [E, H, I]/[E, I]
# split the expert intermediate (column), w2 [E, I, H] its input features
# (row, summed before b2); router and b2 replicate
GPT_MOE_TP_COL = GPT_TP_COL + (("mlp", "w1"), ("mlp", "b1"))
GPT_MOE_TP_ROW = GPT_TP_ROW + (("mlp", "w2"),)


def _check_pattern(units: int, moe_every: int) -> None:
    # every stage runs the same module, so the MoE pattern repeats per
    # stage; with moe_every | units the stage-local placement (u + 1) %
    # moe_every is the monolithic model's global placement
    if moe_every <= 0 or units % moe_every:
        raise ValueError(
            f"moe_every ({moe_every}) must divide units_per_stage "
            f"({units}) so the per-stage MoE pattern matches the "
            f"monolithic block placement")


class GptEncoderUnit(torch.nn.Module):
    """One transformer block (attention + MLP) over (hidden, side)."""

    def __init__(self, config: Any, deterministic: bool = True):
        super().__init__()
        self.attn = GptBlock_Attn(config, deterministic=deterministic)
        self.mlp = GptBlock_Mlp(config, deterministic=deterministic)

    def forward(self, hidden, side):
        return self.mlp(self.attn(hidden)), side


class GptEncoderStage(_RematStage):
    """``units`` rematerialized blocks = one uniform pipeline stage."""

    def __init__(self, config: Any, units: int, deterministic: bool = True):
        super().__init__()
        self.units = units
        for u in range(units):
            self.add_module(f"unit_{u}",
                            GptEncoderUnit(config, deterministic))


class _GptMoeUnit(torch.nn.Module):
    def __init__(self, config, is_moe, num_experts, top_k, capacity_factor,
                 deterministic):
        super().__init__()
        self.is_moe = is_moe
        self.attn = GptBlock_Attn(config, deterministic=deterministic)
        self.mlp = (GptBlock_MoeMlp(config, num_experts=num_experts,
                                    top_k=top_k,
                                    capacity_factor=capacity_factor,
                                    deterministic=deterministic,
                                    return_aux=True)
                    if is_moe else
                    GptBlock_Mlp(config, deterministic=deterministic))

    def forward(self, hidden, side):
        hidden = self.attn(hidden)
        if not self.is_moe:
            return self.mlp(hidden), side
        hidden, aux = self.mlp(hidden)
        return hidden, side + aux.to(side.dtype)


class GptMoeEncoderStage(_RematStage):
    """``units`` blocks where every ``moe_every``-th MLP is a Switch MoE
    (``GptBlock_MoeMlp``); each MoE block adds its aux scalar onto the
    ring's side tensor ([mb]).  Parameter names mirror the monolithic
    block (``unit_u.mlp.router``, ``w1`` ... ``b2``)."""

    def __init__(self, config: Any, units: int, moe_every: int,
                 num_experts: int = 8, top_k: int = 1,
                 capacity_factor: float = 1.25, deterministic: bool = True):
        super().__init__()
        self.units = units
        self.moe_every = moe_every
        for u in range(units):
            is_moe = moe_every > 0 and (u + 1) % moe_every == 0
            self.add_module(f"unit_{u}", _GptMoeUnit(
                config, is_moe, num_experts, top_k, capacity_factor,
                deterministic))


class _TpGptAttn:
    """Megatron attention half: col-parallel q/k/v, row-parallel
    c_proj.  GPT's dropouts all act on replicated activations (after the
    row-parallel sum), so their masks are equal across tp."""

    def __init__(self, cfg: GptConfig, tp: int):
        self.cfg, self.tp = cfg, tp

    def __call__(self, params, hidden, devices, seed):
        cfg, tp = self.cfg, self.tp
        dt = torch_dtype(cfg.dtype)
        n_heads = cfg.num_attention_heads // tp
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        x = [_tp_layer_norm(h, p, "attn.ln_1", 1e-5).to(dt)
             for h, p in zip(hidden, params)]

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], n_heads, head_dim)

        q, k, v = (_tp_dense(x, params, f"attn.{n}", dt, "col", devices)
                   for n in ("q_proj", "k_proj", "v_proj"))
        ctx = []
        for t in range(tp):
            L = q[t].shape[1]
            scores = torch.einsum("blhd,bmhd->bhlm", split(q[t]),
                                  split(k[t])) / math.sqrt(head_dim)
            causal = torch.ones(L, L, dtype=torch.bool,
                                device=scores.device).tril()
            scores = torch.where(causal[None, None], scores, -math.inf)
            probs = torch.softmax(scores.float(), -1).to(dt)
            c = torch.einsum("bhlm,bmhd->blhd", probs, split(v[t]))
            ctx.append(c.reshape(c.shape[0], c.shape[1],
                                 cfg.hidden_size // tp))
        out = _tp_dense(ctx, params, "attn.c_proj", dt, "row", devices)
        return [h + dropout(o, cfg.dropout_prob, seed)
                for h, o in zip(hidden, out)]


class _TpGptMlp:
    """Megatron dense MLP half: col-parallel c_fc, row-parallel c_proj."""

    def __init__(self, cfg: GptConfig, tp: int):
        self.cfg, self.tp = cfg, tp

    def __call__(self, params, hidden, devices, seed):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        act = ACT2FN[cfg.hidden_act]
        x = [_tp_layer_norm(h, p, "mlp.ln_2", 1e-5).to(dt)
             for h, p in zip(hidden, params)]
        x = [act(y) for y in _tp_dense(x, params, "mlp.c_fc", dt, "col",
                                       devices)]
        x = _tp_dense(x, params, "mlp.c_proj", dt, "row", devices)
        return [h + dropout(y, cfg.dropout_prob, seed)
                for h, y in zip(hidden, x)]


class _TpGptMoeMlp:
    """Megatron-sharded Switch MoE MLP half: w1/b1 hold the ``I/tp``
    column shard, w2 the matching row shard whose partial expert outputs
    are summed over tp before the replicated b2.  Router, dispatch and
    the aux loss are computed identically at every tp position from the
    replicated activations."""

    def __init__(self, cfg: GptConfig, tp: int, num_experts: int,
                 top_k: int, capacity_factor: float):
        self.cfg, self.tp = cfg, tp
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor

    def __call__(self, params, hidden, devices, seed):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        act = ACT2FN[cfg.hidden_act]
        routes = [moe_route(_tp_layer_norm(h, p, "mlp.ln_2", 1e-5).to(dt),
                            p["mlp.router"], self.num_experts, self.top_k,
                            self.capacity_factor)
                  for h, p in zip(hidden, params)]
        parts = [expert_mlp(moe_dispatch(tokens, dispatch),
                            p["mlp.w1"].to(dt), p["mlp.b1"].to(dt),
                            p["mlp.w2"].to(dt), None, act)
                 for (tokens, dispatch, _, _), p in zip(routes, params)]
        full = psum(parts, devices)
        outs, auxes = [], []
        for (_, _, combine, aux), y, p, h in zip(routes, full, params,
                                                 hidden):
            y = y + p["mlp.b2"][:, None, :].to(dt)
            out = moe_combine(combine, y).reshape(h.shape).to(dt)
            outs.append(h + dropout(out, cfg.dropout_prob, seed))
            auxes.append(aux)
        return outs, auxes


class TpGptUnit:
    """Megatron-style tensor-parallel GPT block over lists indexed by
    the tp position; parameter names as :class:`GptEncoderUnit`'s with
    tp-local shapes."""

    def __init__(self, config: Any, tp: int, deterministic: bool = True):
        self.cfg = GptConfig.from_dict(config)
        _check_tp(self.cfg, tp)
        self.deterministic = deterministic
        self.attn = _TpGptAttn(self.cfg, tp)
        self.mlp = _TpGptMlp(self.cfg, tp)

    def _seeds(self, seed):
        if self.deterministic or seed is None:
            return None, None
        return fold_seed(seed, 0), fold_seed(seed, 1)

    def __call__(self, params, hidden, side, devices, seed=None):
        s_attn, s_mlp = self._seeds(seed)
        hidden = self.attn(params, hidden, devices, s_attn)
        return self.mlp(params, hidden, devices, s_mlp), side


class TpGptStage(TpEncoderStage):
    """``units`` tensor-parallel GPT blocks, each rematerialized."""

    unit_cls = TpGptUnit


class _TpGptMoeUnit(TpGptUnit):
    def __init__(self, config, tp, deterministic, is_moe, num_experts,
                 top_k, capacity_factor):
        super().__init__(config, tp, deterministic)
        self.is_moe = is_moe
        if is_moe:
            self.mlp = _TpGptMoeMlp(self.cfg, tp, num_experts, top_k,
                                    capacity_factor)

    def __call__(self, params, hidden, side, devices, seed=None):
        if not self.is_moe:
            return super().__call__(params, hidden, side, devices, seed)
        s_attn, s_mlp = self._seeds(seed)
        hidden = self.attn(params, hidden, devices, s_attn)
        hidden, auxes = self.mlp(params, hidden, devices, s_mlp)
        return hidden, [s + a.to(s.dtype) for s, a in zip(side, auxes)]


class TpGptMoeStage(TpEncoderStage):
    """``units`` tensor-parallel blocks, every ``moe_every``-th MLP a
    tp-sharded Switch MoE; the aux loss accumulates on the side tensor
    as in :class:`GptMoeEncoderStage`."""

    def __init__(self, config: Any, units: int, moe_every: int, tp: int,
                 num_experts: int = 8, top_k: int = 1,
                 capacity_factor: float = 1.25, deterministic: bool = True):
        self.units = [
            _TpGptMoeUnit(config, tp, deterministic,
                          moe_every > 0 and (u + 1) % moe_every == 0,
                          num_experts, top_k, capacity_factor)
            for u in range(units)]


class CompiledGptPipeline(CompiledBertPipeline):
    """GPT causal LM with blocks pipelined across a ('pp',) / ('dp',
    'pp') / ('dp', 'pp', 'tp') mesh; the BERT engine's schedules, tensor
    parallelism, ZeRO and train step."""

    tp_col_modules = GPT_TP_COL
    tp_row_modules = GPT_TP_ROW
    _END_GROUPS = ("embeddings", "lm_head")
    _UNIT_LAYERS = ("attn", "mlp")

    def __init__(self, config, mesh, units_per_stage, *args,
                 moe_every: int = 0, num_experts: int = 8,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_coef: float = 0.01, **kwargs):
        self.moe_every = int(moe_every)
        self.num_experts = int(num_experts)
        self.moe_top_k = int(moe_top_k)
        self.moe_capacity_factor = float(moe_capacity_factor)
        self.moe_aux_coef = float(moe_aux_coef)
        super().__init__(config, mesh, units_per_stage, *args, **kwargs)

    @staticmethod
    def _parse_config(config):
        return GptConfig.from_dict(config)

    def _build_modules(self, units_per_stage: int, num_classes: int) -> None:
        cfg = self.cfg.to_dict()
        det = self.deterministic
        self.embeddings = GptEmbeddings(cfg, deterministic=det)
        if self.moe_every:
            self.stage = GptMoeEncoderStage(
                cfg, units_per_stage, self.moe_every, self.num_experts,
                self.moe_top_k, self.moe_capacity_factor, deterministic=det)
            self.side_outputs = True
            # the expert tensors join the Megatron role tables, both for
            # splitting weights and for the replicated leaves' gradients
            self.tp_col_modules = GPT_MOE_TP_COL
            self.tp_row_modules = GPT_MOE_TP_ROW
            self.tp_stage = (
                TpGptMoeStage(cfg, units_per_stage, self.moe_every, self.tp,
                              self.num_experts, self.moe_top_k,
                              self.moe_capacity_factor, deterministic=det)
                if self.tp > 1 else None)
        else:
            self.stage = GptEncoderStage(cfg, units_per_stage,
                                         deterministic=det)
            self.tp_stage = (TpGptStage(cfg, units_per_stage, self.tp,
                                        deterministic=det)
                             if self.tp > 1 else None)
        self.lm_head = GptLmHead(cfg, deterministic=det)

    def init_tree(self, seed: int):
        if self.moe_every:
            _check_pattern(self.units_per_stage, self.moe_every)
        return super().init_tree(seed)

    def _logits(self, params, input_ids, rng=None):
        rng = self._check_rng(rng)
        dev = self.home_device

        def sub(i):
            return None if rng is None else fold_seed(rng, i)

        with seeded(sub(0), dev):
            hidden = _call(self.embeddings, self._ends(params, "embeddings"),
                           _as_tensor(input_ids, dev))
        B = hidden.shape[0]
        hidden_mb = self._split_batch(hidden)
        # the side rides the ring with its microbatch: a zero placeholder
        # for dense stages, MoE's aux accumulator (kept float32 under
        # bf16) for MoE stages
        side_dtype = torch.float32 if self.side_outputs else hidden.dtype
        side_mb = torch.zeros(hidden_mb.shape[:2], dtype=side_dtype,
                              device=dev)
        encoded = self._encoder(params["stages"], hidden_mb, side_mb, sub(1))
        aux = None
        if self.side_outputs:
            encoded, side_out = encoded
            aux = side_out.mean()  # over microbatches of the summed aux
        encoded = encoded.reshape(B, *encoded.shape[2:])
        with seeded(sub(2), dev):
            logits = _call(self.lm_head, self._ends(params, "lm_head"),
                           encoded)
        return (logits, aux) if self.side_outputs else logits

    def loss(self, params, batch, labels, rng=None):
        (input_ids,) = batch if isinstance(batch, tuple) else (batch,)
        out = self._logits(params, input_ids, rng=rng)
        logits, aux = out if self.side_outputs else (out, None)
        loss = causal_lm_loss(logits, _as_tensor(labels, logits.device))
        if aux is not None:
            loss = loss + self.moe_aux_coef * aux.float()
        return loss


__all__ = [
    "CompiledGptPipeline",
    "GPT_MOE_TP_COL",
    "GPT_MOE_TP_ROW",
    "GPT_TP_COL",
    "GPT_TP_ROW",
    "GptEncoderStage",
    "GptEncoderUnit",
    "GptMoeEncoderStage",
    "TpGptMoeStage",
    "TpGptStage",
    "TpGptUnit",
]
