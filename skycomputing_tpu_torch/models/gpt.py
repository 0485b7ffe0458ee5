"""GPT-style causal LM units, for training and for KV-cache serving.

The port of ``skycomputing_tpu/models/gpt.py``:
the same registered units, the same layer-config lists, the same
numerics —

====================  ===================================  =======================
registered name       paged decode step                    full-sequence forward
====================  ===================================  =======================
``GptEmbeddings``     ``decode(ids, index)`` -> hidden     ``forward(ids)``
``GptBlock_Attn``     ``decode_paged(hidden, k, v, ...)``  ``forward(hidden)``
``GptBlock_Mlp``      ``forward(hidden)`` -> hidden        the same
``GptBlock_MoeMlp``   ``forward(hidden)`` -> hidden        the same
``GptLmHead``         ``forward(hidden)`` -> logits        the same
====================  ===================================  =======================

``GptBlock_Attn.decode`` is the slot-layout step (one ``[B, max_len,
heads, head_dim]`` slab pair per unit): :func:`apply_kv_cached` threads
it through a module slice for the serving engine's slot layout, the
single-request :class:`CachedGptDecoder` and the decode profile
(``serving/profile.py``).  The full-sequence forwards are what the
trainer runs (``PipelineModel`` over ``(input_ids,)`` batches with the
ids as labels and ``CausalLmLoss``; the launcher's ``SKYTPU_MODEL=gpt``),
with dropout after the embeddings, the attention projection and the MLP
in train mode as in JAX, what :func:`generate` decodes against (the
one-shot reference the serving bench holds every engine to) and what
the pre-flight verifier (``analysis/plan_check.py``) threads shapes
through on ``meta``.

Numerics follow flax's ``dtype``/``param_dtype`` pair: parameters are
float32, dense layers and embeddings compute in ``cfg.dtype``,
LayerNorm runs in float32 with eps 1e-5 and its output is cast to
``cfg.dtype``, and logits come out in float32.  Paged attention goes
through ``ops/paged_attention.py``: the CUDA kernel on the card (over fp
or int8 pages), its plain version on the CPU or where the caller asks
for it (``plain=True``).  :func:`draft_slice_indices` cuts the
speculative draft out of a stack.

Sampling (``temperature > 0``) in :func:`generate` and
:func:`generate_cached` draws from a ``torch.Generator``, so the two
agree with each other; greedy decoding is the reference's token for
token.

``GptBlock_MoeMlp`` replaces the MLP of every ``moe_every``-th block
(:func:`gpt_layer_configs`): a top-k router over experts stacked on a
leading axis, fixed-capacity dispatch (``ops/moe.py``), the Switch
load-balance loss kept on the module as ``aux_loss`` (JAX sows it into
``intermediates``) or returned with ``return_aux=True``.

``GptBlock_Attn(mesh=...)`` shards its full-sequence forward over a 1-d
mesh with causal ring attention (``parallel/ring_attention.py``), as in
JAX; cached decoding rejects such a block (:func:`decode_modules`).  On
``meta`` such a block runs one position's program over its L/S rows
(:func:`..parallel.mesh.one_position`), as XLA's cost analysis charges
the JAX block's sharded program.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.paged_attention import paged_attention, paged_attention_reference
from ..registry import LAYER
from ..utils import torch_dtype
from .bert import ACT2FN, _Dense, _dropout, _embed, _layer_norm

# serving/kv_cache.py is imported function-locally, as in the JAX
# package: the serving package imports this module, never the reverse
# at import time.


class GptConfig:
    def __init__(
        self,
        vocab_size: int = 50257,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: Optional[int] = None,
        max_position_embeddings: int = 1024,
        hidden_act: str = "gelu",
        dropout_prob: float = 0.1,
        initializer_range: float = 0.02,
        dtype: str = "bfloat16",
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_act = hidden_act
        self.dropout_prob = dropout_prob
        self.initializer_range = initializer_range
        self.dtype = dtype

    @classmethod
    def from_dict(cls, data) -> "GptConfig":
        if isinstance(data, GptConfig):
            return data
        data = dict(data)
        known = set(inspect.signature(cls.__init__).parameters) - {"self"}
        # known keys go through __init__ so derived defaults (e.g.
        # intermediate_size = 4*hidden_size) follow the dict's values
        cfg = cls(**{k: v for k, v in data.items() if k in known})
        for k, v in data.items():
            if k not in known:
                setattr(cfg, k, v)
        return cfg

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _gcfg(config) -> GptConfig:
    return GptConfig.from_dict(config)


@LAYER.register_module
class GptEmbeddings(nn.Module):
    """Token + learned position embeddings (``wte``/``wpe``)."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = _gcfg(config)
        cfg = self.config
        std = cfg.initializer_range
        self.wte = _embed(cfg.vocab_size, cfg.hidden_size, std)
        self.wpe = _embed(cfg.max_position_embeddings, cfg.hidden_size, std)
        self.drop = _dropout(cfg.dropout_prob, deterministic)

    def forward(self, input_ids):
        """Embed ``input_ids`` [B, L] at positions 0..L-1."""
        cfg = self.config
        seq_len = input_ids.shape[1]
        if seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq_len} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings}"
            )
        dt = torch_dtype(cfg.dtype)
        positions = torch.arange(seq_len, device=input_ids.device)[None, :]
        hidden = (self.wte(input_ids.long()).to(dt)
                  + self.wpe(positions).to(dt))
        return self.drop(hidden)

    def decode(self, input_ids, index):
        """Embed ``input_ids`` [B, Lq] at positions index..index+Lq-1
        (``index`` a scalar or a per-row [B] tensor)."""
        from ..serving.kv_cache import decode_positions

        dt = torch_dtype(self.config.dtype)
        positions = decode_positions(index, input_ids.shape[1]).long()
        return (self.wte(input_ids.long()).to(dt)
                + self.wpe(positions).to(dt))


@LAYER.register_module
class GptBlock_Attn(nn.Module):
    """Pre-LN causal self-attention half of a transformer block."""

    def __init__(self, config: Any, deterministic: bool = False,
                 mesh: Any = None, axis_name: str = "sp"):
        super().__init__()
        self.config = _gcfg(config)
        self.mesh = mesh
        self.axis_name = axis_name
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        H = cfg.hidden_size
        self.ln_1 = nn.LayerNorm(H, eps=1e-5)
        self.q_proj = _Dense(H, H, dt, cfg.initializer_range)
        self.k_proj = _Dense(H, H, dt, cfg.initializer_range)
        self.v_proj = _Dense(H, H, dt, cfg.initializer_range)
        self.c_proj = _Dense(H, H, dt, cfg.initializer_range)
        self.drop = _dropout(cfg.dropout_prob, deterministic)

    def _qkv(self, hidden):
        cfg = self.config
        n_heads = cfg.num_attention_heads
        head_dim = cfg.hidden_size // n_heads
        x = _layer_norm(hidden, self.ln_1).to(torch_dtype(cfg.dtype))

        def split_heads(t):
            return t.reshape(t.shape[0], t.shape[1], n_heads, head_dim)

        return (split_heads(self.q_proj(x)), split_heads(self.k_proj(x)),
                split_heads(self.v_proj(x)))

    def _attend(self, q, k, v, visible):
        """Softmax attention of q [B, Lq, heads, D] over k/v [B, M, heads,
        D] where ``visible`` [B|1, Lq, M] allows: scores in the model
        dtype over sqrt(D), a float32 softmax, the context projected back
        into the model dtype."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        scores = torch.einsum("blhd,bmhd->bhlm", q, k.to(dt)) / math.sqrt(
            head_dim)
        scores = torch.where(visible[:, None], scores, -math.inf)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v.to(dt))
        return self.c_proj(ctx.reshape(ctx.shape[0], ctx.shape[1],
                                       cfg.hidden_size))

    def forward(self, hidden):
        """Causal self-attention over the whole sequence [B, L, H]; with a
        ``mesh``, causal ring attention over its ``axis_name`` positions
        (float32 scores and softmax, the context in the model dtype)."""
        if self.mesh is not None:
            from ..parallel.mesh import one_position
            from ..parallel.ring_attention import (
                check_ring,
                ring_attention,
                ring_position,
            )

            if hidden.device.type == "meta":
                # the static profile and the pre-flight: one position's
                # program over its L/S rows, as XLA charges JAX's
                S = len(self.mesh.ring(self.axis_name, hidden))
                check_ring(hidden.shape[1], S, self.axis_name)
                return one_position(
                    lambda rows: self._ring_out(
                        rows, ring_position(*self._qkv(rows), causal=True)),
                    S, hidden)
            ctx = ring_attention(*self._qkv(hidden), self.mesh,
                                 axis_name=self.axis_name, causal=True)
            return self._ring_out(hidden, ctx)
        q, k, v = self._qkv(hidden)
        L = q.shape[1]
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=q.device).tril()[None]
        return hidden + self.drop(self._attend(q, k, v, causal))

    def _ring_out(self, hidden, ctx):
        return hidden + self.drop(self.c_proj(
            ctx.reshape(ctx.shape[0], ctx.shape[1], self.config.hidden_size)))

    def decode(self, hidden, k_cache, v_cache, index):
        """One incremental step against SLOT slabs.

        ``hidden``: [B, Lq, H] new positions index..index+Lq-1;
        ``k_cache``/``v_cache``: [B, max_len, heads, head_dim], written in
        place (:func:`~..serving.kv_cache.update_kv_cache`) before
        attention reads them; ``index`` a scalar or a per-row [B] tensor.
        Positions past a row's own are masked
        (:func:`~..serving.kv_cache.decode_visibility`).  Returns
        (new_hidden, k_cache, v_cache).
        """
        from ..serving.kv_cache import decode_visibility, update_kv_cache

        q, k_new, v_new = self._qkv(hidden)
        k_cache, v_cache = update_kv_cache(k_cache, v_cache, k_new, v_new,
                                           index)
        visible = decode_visibility(index, q.shape[1], k_cache.shape[1])
        return (hidden + self._attend(q, k_cache, v_cache, visible),
                k_cache, v_cache)

    def decode_paged(self, hidden, k_slab, v_slab, page_table, index,
                     write, plain: bool = False):
        """One incremental step against PAGED slabs.

        ``hidden``: [R, Lq, H] new positions index..index+Lq-1 per row;
        ``k_slab``/``v_slab``: [num_pages, page_size, heads, head_dim]
        physical page pools shared by every row, or
        :class:`~..serving.kv_cache.QuantizedPages` (int8 values + scale
        slab); ``page_table``: [R, W] int32 on the slabs' device
        (sentinel-padded); ``index``: [R] int32 on the slabs' device;
        ``write``: the step's plan for this slab type
        (:func:`~..serving.kv_cache.write_plan`).  The new K/V are
        written into the slabs in place BEFORE attention reads them.
        ``plain`` runs the kernel's plain version on any device (the
        serving engine's ``attn_impl="plain"``); otherwise the kernel's
        wrapper picks by device.  Returns (new_hidden, k_slab, v_slab).
        """
        from ..serving.kv_cache import QuantizedPages, scatter_kv

        cfg = self.config
        attend = paged_attention_reference if plain else paged_attention
        q, k_new, v_new = self._qkv(hidden)
        scatter_kv(k_slab, v_slab, k_new, v_new, write)
        if isinstance(k_slab, QuantizedPages):
            ctx = attend(q, k_slab.values, v_slab.values, page_table, index,
                         k_scale=k_slab.scale, v_scale=v_slab.scale)
        else:
            ctx = attend(q, k_slab, v_slab, page_table, index)
        ctx = ctx.to(torch_dtype(cfg.dtype))
        ctx = ctx.reshape(ctx.shape[0], ctx.shape[1], cfg.hidden_size)
        return hidden + self.c_proj(ctx), k_slab, v_slab


@LAYER.register_module
class GptBlock_Mlp(nn.Module):
    """Pre-LN MLP half of a transformer block."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = _gcfg(config)
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.c_fc = _Dense(cfg.hidden_size, cfg.intermediate_size, dt,
                           cfg.initializer_range)
        self.c_proj = _Dense(cfg.intermediate_size, cfg.hidden_size, dt,
                             cfg.initializer_range)
        self.drop = _dropout(cfg.dropout_prob, deterministic)

    def forward(self, hidden):
        cfg = self.config
        act = ACT2FN[cfg.hidden_act]
        x = _layer_norm(hidden, self.ln_2).to(torch_dtype(cfg.dtype))
        return hidden + self.drop(self.c_proj(act(self.c_fc(x))))


@LAYER.register_module
class GptBlock_MoeMlp(nn.Module):
    """Pre-LN mixture-of-experts MLP half of a transformer block.

    Parameters ``router [H, E]``, ``w1 [E, H, I]``, ``b1 [E, I]``, ``w2
    [E, I, H]``, ``b2 [E, H]`` (float32, the JAX block's layout), the
    experts computed in ``cfg.dtype``; dropout after the combine.  The
    load-balance loss of the last forward is ``self.aux_loss``, detached
    from the graph; with ``return_aux`` the forward returns ``(hidden,
    aux)``, which carries the gradient."""

    #: capacity, routing priority and the aux loss are over all B*L
    #: tokens of a call, so a split of the rows changes the result
    couples_rows = True

    def __init__(self, config: Any, num_experts: int = 8, top_k: int = 1,
                 capacity_factor: float = 1.25, deterministic: bool = False,
                 return_aux: bool = False):
        super().__init__()
        self.config = cfg = _gcfg(config)
        self.num_experts = E = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.return_aux = return_aux
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.ln_2 = nn.LayerNorm(H, eps=1e-5)
        self.router = nn.Parameter(torch.empty(H, E))
        self.w1 = nn.Parameter(torch.empty(E, H, I))
        self.b1 = nn.Parameter(torch.empty(E, I))
        self.w2 = nn.Parameter(torch.empty(E, I, H))
        self.b2 = nn.Parameter(torch.empty(E, H))
        self.drop = _dropout(cfg.dropout_prob, deterministic)
        self.aux_loss = None

    @staticmethod
    def initial_params(config: Any, num_experts: int, normal) -> dict:
        """The block's own parameters as the flax initializers draw them:
        router and expert kernels ~ N(0, initializer_range) from
        ``normal(shape, std)``, in that order, biases 0."""
        cfg = _gcfg(config)
        E, H, I = num_experts, cfg.hidden_size, cfg.intermediate_size
        std = cfg.initializer_range
        return {"router": normal((H, E), std), "w1": normal((E, H, I), std),
                "b1": torch.zeros(E, I), "w2": normal((E, I, H), std),
                "b2": torch.zeros(E, H)}

    def initial_state(self, normal) -> dict:
        """:meth:`initial_params` of this block (the parameter server's
        hook for a module's own parameters)."""
        return self.initial_params(self.config, self.num_experts, normal)

    def forward(self, hidden):
        from ..ops.moe import expert_mlp, moe_dispatch_combine, moe_route

        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        act = ACT2FN[cfg.hidden_act]
        x = _layer_norm(hidden, self.ln_2).to(dt)
        tokens, dispatch, combine, aux = moe_route(
            x, self.router, self.num_experts, self.top_k,
            self.capacity_factor)
        self.aux_loss = aux.detach()
        out = moe_dispatch_combine(
            tokens, dispatch, combine,
            lambda buf: expert_mlp(buf, self.w1.to(dt), self.b1.to(dt),
                                   self.w2.to(dt), self.b2.to(dt), act))
        out = self.drop(out.reshape(hidden.shape).to(dt))
        if self.return_aux:
            return hidden + out, aux
        return hidden + out


@LAYER.register_module
class GptLmHead(nn.Module):
    """Final LayerNorm + vocabulary projection; float32 logits."""

    def __init__(self, config: Any, deterministic: bool = False):
        super().__init__()
        self.config = _gcfg(config)
        cfg = self.config
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.lm_head = _Dense(cfg.hidden_size, cfg.vocab_size,
                              torch_dtype(cfg.dtype), cfg.initializer_range)

    def forward(self, hidden):
        x = _layer_norm(hidden, self.ln_f).to(torch_dtype(self.config.dtype))
        return self.lm_head(x).float()


def gpt_layer_configs(config: Any, num_blocks: Optional[int] = None,
                      deterministic: bool = False, mesh: Any = None,
                      moe_every: int = 0, num_experts: int = 8,
                      moe_top_k: int = 1,
                      moe_capacity_factor: float = 1.25) -> list:
    """Full layer-config list: embeddings + blocks x (attn, mlp) + LM
    head — the same dicts the JAX package's ``gpt_layer_configs``
    builds.  ``moe_every=n`` makes every n-th block's MLP a
    :class:`GptBlock_MoeMlp` (0: dense only)."""
    cfg = _gcfg(config)
    if num_blocks is None:
        num_blocks = cfg.num_hidden_layers
    blocks = []
    for b in range(num_blocks):
        blocks.append(dict(layer_type="GptBlock_Attn", config=cfg.to_dict(),
                           deterministic=deterministic, mesh=mesh))
        if moe_every and (b + 1) % moe_every == 0:
            blocks.append(dict(layer_type="GptBlock_MoeMlp",
                               config=cfg.to_dict(), num_experts=num_experts,
                               top_k=moe_top_k,
                               capacity_factor=moe_capacity_factor,
                               deterministic=deterministic))
        else:
            blocks.append(dict(layer_type="GptBlock_Mlp",
                               config=cfg.to_dict(),
                               deterministic=deterministic))
    return (
        [dict(layer_type="GptEmbeddings", config=cfg.to_dict(),
              deterministic=deterministic)]
        + blocks
        + [dict(layer_type="GptLmHead", config=cfg.to_dict(),
                deterministic=deterministic)]
    )


def random_state_dicts(layer_cfgs: Sequence[dict], seed: int) -> List[dict]:
    """Per-layer float32 state dicts drawn from ``np.random.default_rng
    (seed)`` the way the JAX initializers draw them: embeddings and dense
    weights ~ N(0, initializer_range), biases 0, LayerNorm scales 1."""
    rng = np.random.default_rng(seed)
    out = []
    for layer_cfg in layer_cfgs:
        cfg = _gcfg(layer_cfg["config"])
        V, H, I = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size
        std = cfg.initializer_range

        def normal(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
            )

        def ln(name):
            return {f"{name}.weight": torch.ones(H),
                    f"{name}.bias": torch.zeros(H)}

        def dense(name, n_in, n_out):
            return {f"{name}.weight": normal(n_out, n_in),
                    f"{name}.bias": torch.zeros(n_out)}

        kind = layer_cfg["layer_type"]
        if kind == "GptEmbeddings":
            sd = {"wte.weight": normal(V, H),
                  "wpe.weight": normal(cfg.max_position_embeddings, H)}
        elif kind == "GptBlock_Attn":
            sd = {**ln("ln_1"), **dense("q_proj", H, H),
                  **dense("k_proj", H, H), **dense("v_proj", H, H),
                  **dense("c_proj", H, H)}
        elif kind == "GptBlock_Mlp":
            sd = {**ln("ln_2"), **dense("c_fc", H, I),
                  **dense("c_proj", I, H)}
        elif kind == "GptBlock_MoeMlp":
            sd = {**ln("ln_2"), **GptBlock_MoeMlp.initial_params(
                cfg, layer_cfg.get("num_experts", 8),
                lambda shape, s: torch.from_numpy(rng.standard_normal(
                    shape, dtype=np.float32) * np.float32(s)))}
        elif kind == "GptLmHead":
            sd = {**ln("ln_f"), **dense("lm_head", H, V)}
        else:
            raise ValueError(f"not a GPT decode layer: {kind!r}")
        out.append(sd)
    return out


def decode_modules(modules) -> list:
    """Validated module list for KV-cache decoding: ring attention is
    rejected (it has no incremental form) and every module is put in
    eval mode."""
    prepared = []
    for m in list(getattr(modules, "layers", modules)):
        if isinstance(m, GptBlock_Attn) and m.mesh is not None:
            raise ValueError(
                "cached decoding does not support ring attention; "
                "build the stack with mesh=None"
            )
        prepared.append(m.eval())
    return prepared


def attn_indices(modules) -> list:
    """Positions of the KV-cache-bearing units in a module slice."""
    return [
        i for i, m in enumerate(modules) if isinstance(m, GptBlock_Attn)
    ]


def draft_slice_indices(modules, draft_blocks: int) -> list:
    """Module indices of the prefix-slice draft model for speculative
    decoding: embeddings + the first ``draft_blocks`` attention units
    (with everything between them) + the LM head.

    The slice is a PREFIX of the stack, so the hidden state entering
    each sliced layer is the target's, and the draft's KV cache for
    those layers IS the target's: it reads and writes the same pages
    and needs no prefill of its own.  Returns the index list into the
    full module list; raises when the stack is not a decodable GPT or
    ``draft_blocks`` leaves no target-only attention unit.
    """
    if not modules or not isinstance(modules[0], GptEmbeddings):
        raise ValueError(
            "expected a GPT stack: GptEmbeddings + GptBlock_Attn units"
        )
    attn = attn_indices(modules)
    if int(draft_blocks) < 1:
        raise ValueError(
            f"draft_blocks must be >= 1, got {draft_blocks}"
        )
    if int(draft_blocks) >= len(attn):
        raise ValueError(
            f"draft_blocks={draft_blocks} must be smaller than the "
            f"target's {len(attn)} attention units — a draft as deep "
            f"as the target cannot speed anything up"
        )
    if not isinstance(modules[-1], GptLmHead):
        raise ValueError(
            "expected the stack to end in GptLmHead (the draft reuses "
            "the target's head at the slice point)"
        )
    # everything before the first attention unit the draft leaves out,
    # then the head
    cut = attn[int(draft_blocks)]
    return list(range(cut)) + [len(modules) - 1]


def paged_step_inputs(slab, page_table, index, valid_len, query_len: int,
                      device):
    """One paged step's shared inputs on ``device``: (page table [R, W]
    int32, index [R] int32, write plan).  ``page_table``, ``index`` and
    ``valid_len`` may lie on the host (numpy or CPU tensors); the write
    plan (:func:`~..serving.kv_cache.write_plan`, for slabs like
    ``slab``) is computed there and moved with the table, so planning
    costs no device synchronisation.  Every attention unit of every
    stage on ``device`` shares the result; ``slab`` None (no attention
    unit to write) gives no plan."""
    from ..serving.kv_cache import write_plan

    table = torch.as_tensor(np.asarray(page_table, np.int32))
    index_h = torch.as_tensor(np.asarray(index, np.int32)).reshape(-1)
    write = None
    if slab is not None:
        write = write_plan(slab, table, index_h, np.asarray(valid_len),
                           query_len).to(device)
    return table.to(device).contiguous(), index_h.to(device), write


@torch.no_grad()
def run_paged_step(modules, data, slabs, step, plain: bool = False):
    """Thread one PAGED step through a module slice, given the step's
    inputs on the slice's device (:func:`paged_step_inputs`).

    ``data`` is token ids [R, Lq] when the slice starts with
    :class:`GptEmbeddings`, else a hidden state; ``slabs`` is one
    ``[num_pages, page_size, heads, head_dim]`` (k, v) pair per attention
    unit (plain tensors, or ``QuantizedPages`` for an int8 pool), updated
    in place; ``plain`` asks every attention unit for the kernel's plain
    version.  Returns (output, slabs).
    """
    n_attn = len(attn_indices(modules))
    if len(slabs) != n_attn:
        raise ValueError(
            f"got {len(slabs)} cache pairs for {n_attn} attention units"
        )
    table, index, write = step
    cache_i = 0
    for module in modules:
        if isinstance(module, GptEmbeddings):
            data = module.decode(data, index)
        elif isinstance(module, GptBlock_Attn):
            k, v = slabs[cache_i]
            data, k, v = module.decode_paged(data, k, v, table, index,
                                             write, plain)
            cache_i += 1
        else:
            data = module(data)
    return data, slabs


def apply_kv_paged(modules, data, slabs, page_table, index, valid_len,
                   plain: bool = False):
    """Thread one PAGED step through a module slice on its own:
    :func:`paged_step_inputs` on the slabs' device (``data``'s for a
    slice without attention units), then :func:`run_paged_step`.
    ``page_table`` [R, W] / ``index`` [R] / ``valid_len`` [R] are shared
    by every layer.  Prefill (``Lq = bucket``), decode (``Lq = 1``) and
    speculative verify (``Lq = k + 1``) are this one function at
    different shapes.  Returns (output, slabs).
    """
    from ..serving.kv_cache import slab_device

    slab = slabs[0][0] if slabs else None
    device = slab_device(slab) if slab is not None else data.device
    step = paged_step_inputs(slab, page_table, index, valid_len,
                             data.shape[1], device)
    return run_paged_step(modules, data, slabs, step, plain)


@torch.no_grad()
def apply_kv_cached(modules, data, caches, index):
    """Thread one SLOT decode step through a module slice.

    ``data`` is token ids [B, Lq] when the slice starts with
    :class:`GptEmbeddings`, else the hidden state handed over from the
    previous stage; ``caches`` is one ``[B, max_len, heads, head_dim]``
    (k, v) slab pair per attention unit, written in place
    (:meth:`GptBlock_Attn.decode`); ``index`` a scalar or a per-row [B]
    vector (host or device).  Returns (output, caches).  The one
    slot-threading implementation: :class:`CachedGptDecoder` runs it over
    the whole stack, the serving engine's slot stages over their slices.
    """
    n_attn = len(attn_indices(modules))
    if len(caches) != n_attn:
        raise ValueError(
            f"got {len(caches)} cache pairs for {n_attn} attention units"
        )
    index = torch.as_tensor(
        index, device=caches[0][0].device if caches else data.device)
    cache_i = 0
    for module in modules:
        if isinstance(module, GptEmbeddings):
            data = module.decode(data, index)
        elif isinstance(module, GptBlock_Attn):
            k, v = caches[cache_i]
            data, _, _ = module.decode(data, k, v, index)
            cache_i += 1
        else:
            data = module(data)
    return data, caches


def _next_tokens(logits, temperature: float, generator) -> torch.Tensor:
    """Each row's next token from its logits [B, V], as a CPU int64 [B]:
    the argmax, or with ``temperature > 0`` a draw from
    ``softmax(logits / temperature)`` taken on the host with
    ``generator`` (so a decoder on any device draws the same tokens)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).cpu()
    probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _check_context(prompt, max_new_tokens: int, context_length: int):
    prompt = np.asarray(prompt)
    if prompt.ndim == 1:
        prompt = prompt[None]
    if prompt.shape[1] + max_new_tokens > context_length:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + new tokens ({max_new_tokens}) "
            f"exceed context_length={context_length}"
        )
    return prompt.astype(np.int32)


@torch.no_grad()
def generate(forward_fn, prompt, max_new_tokens: int, context_length: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, pad_id: int = 0):
    """Autoregressive decoding against any fixed-shape forward function.

    ``forward_fn(input_ids) -> logits [B, L, V]`` takes a CPU int64
    tensor [B, context_length] (moving it to its own device), e.g. a
    full-sequence GPT stack (:func:`one_shot_forward`).  The prompt
    ([L] or [B, L]) is right-padded to ``context_length``, so every call
    has one shape; greedy when ``temperature == 0``, else a draw per step
    from ``generator`` (a CPU ``torch.Generator``, seeded 0 when None).
    Returns the int32 array [B, L + max_new_tokens].
    """
    prompt = _check_context(prompt, max_new_tokens, context_length)
    batch, length = prompt.shape
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    tokens = np.full((batch, context_length), pad_id, dtype=np.int32)
    tokens[:, :length] = prompt
    for _ in range(max_new_tokens):
        logits = forward_fn(torch.from_numpy(tokens).long())
        nxt = _next_tokens(logits[:, length - 1], temperature, generator)
        tokens[:, length] = nxt.numpy().astype(np.int32)
        length += 1
    return tokens[:, :length]


def one_shot_forward(layer_cfgs: Sequence[dict], state_dicts: Sequence[Any],
                     device=None):
    """A full-sequence forward over the whole stack for :func:`generate`:
    the stack built from ``layer_cfgs``, loaded from ``state_dicts``, in
    eval mode on ``device`` (the card unless the caller names another);
    the returned function takes CPU token ids and returns the logits."""
    from ..builder import build_layer_stack
    from ..utils import resolve_device

    dev = resolve_device(device)
    stack = build_layer_stack(list(layer_cfgs))
    for module, sd in zip(stack.layers, state_dicts):
        module.load_state_dict(sd, strict=True)
    stack = stack.to(dev).eval()

    @torch.no_grad()
    def forward(ids):
        return stack(ids.to(dev))

    return forward


class CachedGptDecoder:
    """KV-cache incremental decoding over the decomposed GPT layer stack:
    the stack's own modules (and weights) with one fixed-shape slot cache
    ``[B, max_len, heads, head_dim]`` per attention unit, written in
    place — O(L) work per token."""

    def __init__(self, stack):
        self.modules = decode_modules(stack)
        self._attn_idx = attn_indices(self.modules)
        if not self._attn_idx or not isinstance(
            self.modules[0], GptEmbeddings
        ):
            raise ValueError(
                "expected a GPT stack: GptEmbeddings + GptBlock_Attn units"
            )

    @property
    def device(self) -> torch.device:
        return next(self.modules[0].parameters()).device

    def init_cache(self, batch: int, max_len: int):
        """Zeroed fixed-shape KV caches on the stack's device: [(k, v)]
        per attention unit."""
        from ..serving.kv_cache import init_layer_caches, kv_spec_from_config

        specs = [
            kv_spec_from_config(self.modules[i].config.to_dict(), max_len)
            for i in self._attn_idx
        ]
        return init_layer_caches(specs, batch, device=self.device)

    def apply_cached(self, tokens, caches, index):
        """Forward ``tokens`` [B, Lq] at positions index..index+Lq-1;
        returns (logits [B, Lq, V], caches)."""
        return apply_kv_cached(self.modules, tokens, caches, index)


@torch.no_grad()
def generate_cached(stack, prompt, max_new_tokens: int, context_length: int,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """KV-cache autoregressive decoding over ``stack`` (a loaded
    ``LayerStack`` or module list, on its own device): one prefill over
    the prompt, then single-token steps.  Token-identical to
    :func:`generate` over the same weights; sampled draws take the same
    ``generator`` sequence, so they match too."""
    prompt = _check_context(prompt, max_new_tokens, context_length)
    decoder = CachedGptDecoder(stack)
    max_pos = decoder.modules[0].config.max_position_embeddings
    if context_length > max_pos:
        raise ValueError(
            f"context_length={context_length} exceeds "
            f"max_position_embeddings={max_pos}"
        )
    if max_new_tokens == 0:
        return prompt
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    batch, start = prompt.shape
    dev = decoder.device
    caches = decoder.init_cache(batch, context_length)
    logits, caches = decoder.apply_cached(
        torch.from_numpy(prompt).to(dev), caches, 0)
    out = [_next_tokens(logits[:, -1], temperature, generator)]
    for index in range(start, start + max_new_tokens - 1):
        logits, caches = decoder.apply_cached(
            out[-1][:, None].to(dev), caches, index)
        out.append(_next_tokens(logits[:, 0], temperature, generator))
    new = torch.stack(out, dim=1).numpy().astype(np.int32)
    return np.concatenate([prompt, new], axis=1)


__all__ = [
    "ACT2FN",
    "GptConfig",
    "GptEmbeddings",
    "GptBlock_Attn",
    "GptBlock_Mlp",
    "GptBlock_MoeMlp",
    "GptLmHead",
    "CachedGptDecoder",
    "apply_kv_cached",
    "apply_kv_paged",
    "attn_indices",
    "decode_modules",
    "draft_slice_indices",
    "generate",
    "generate_cached",
    "gpt_layer_configs",
    "one_shot_forward",
    "paged_step_inputs",
    "random_state_dicts",
    "run_paged_step",
]
