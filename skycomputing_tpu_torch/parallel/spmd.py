"""Compiled SPMD pipeline: GPipe and interleaved schedules over a ('pp',),
('dp', 'pp') or ('dp', 'pp', 'tp') :class:`~.mesh.Mesh` (the port of
``skycomputing_tpu/parallel/spmd.py``).

The JAX engine compiles one program over the mesh: uniform stages whose
parameters stack on a leading ``S x V`` axis sharded over ``pp``, an
activation handoff by ``ppermute``, per-stage gradients summed over
``dp`` by shard_map's transpose, Megatron tensor parallelism with
``psum`` in the stage body, ZeRO-1/2/3 as sharding annotations.  This
engine is the same computation driven from one Python process:

- every leaf is a :class:`~.sharded.ShardedLeaf` whose local tensor at
  each mesh position has the shape of the JAX array's shard there (the
  stage stack ``[S*V, (tp,) ...]`` over ``pp`` and ``tp``, a ZeRO-3 leaf
  one weight axis over ``dp`` too, the ends whole at every position);
- a ``ppermute`` is ``Tensor.to(next position's device)``, a ``psum``
  over ``tp`` an explicit sum of the positions' partials moved back to
  each; autograd carries gradients back through both, every tp copy of
  a replicated stage leaf gets the sum of the copies' gradients (JAX's
  ``_psum_grad_tp``), and :func:`~.sharded.reduce_gradients` sums each
  shard's gradient over its replicas (the ``dp`` transpose);
- the schedules run their cells in the JAX program's tick order, but a
  single controller computes no bubble cell and no zero pad: JAX
  computes those and throws their results away because one SPMD program
  runs at every tick, and skipping them changes no result;
- the ends (embeddings, pooler, classifier) run once, at the mesh's
  first position, on its copy of their parameters (JAX computes them
  replicated); every copy receives the same update;
- each encoder unit is rematerialized (``torch.utils.checkpoint``, as
  ``nn.remat``), so its backward re-runs its forward: with
  ``use_flash_attention`` a BERT stage launches B1
  (``ops/flash_attention.py``) once per unit, microbatch and dp position
  in the forward and again in the backward.  The tensor-parallel stage
  computes attention with einsums and no kernel, as JAX's does.

Dropout (``deterministic=False``) draws one mask per (stage or chunk,
microbatch) cell from a seed folded from the step's ``rng`` (an int) by
the ``pp`` position, the ``dp`` position where there is one, and the
tick.  A plain stage runs its cell under that seed (the global
generator, restored afterwards; each unit's recompute replays its
generator state); a tensor-parallel stage draws each mask from its own
``torch.Generator`` seeded from the cell's seed, the unit and the site,
equal across ``tp`` on replicated activations and folded by the ``tp``
position on the head-sharded attention probabilities.  JAX's threefry
bits are not matched: the contracts are rate 0 equal to the
deterministic engine, seeded runs equal, different seeds different.

Parameters are float32 and the optimizer is optax's ``sgd`` or ``adam``
at optax's defaults (:mod:`.sharded`); ZeRO-1 holds the optimizer state
as ``dp`` shards, ZeRO-2 the reduced gradient too, ZeRO-3 the stage
parameters, each tick gathering only the chunk in use.  The engine runs
on the card unless the mesh's devices are CPU devices.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..dynamics.parameter_server import init_state_dict
from ..models.bert import (
    ACT2FN,
    BertEmbeddings,
    BertLayer_Body,
    BertLayer_Head,
    BertLayer_Tail,
    BertPooler,
    BertTailForClassification,
)
from ..models.bert_config import BertConfig
from ..utils import torch_dtype
from .sharded import (
    ShardedLeaf,
    apply_updates,
    init_state,
    leaves_of,
    map_tree,
    optimizer_from,
    psum,
    reduce_gradients,
)

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64's
    finalizer): the port's ``jax.random.fold_in``."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


@contextlib.contextmanager
def seeded(seed: Optional[int], device: torch.device):
    """Run under ``seed`` on ``device``'s generator, restoring it after
    (nothing when ``seed`` is None)."""
    if seed is None:
        yield
        return
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[device] if cuda else []):
        if cuda:
            with torch.cuda.device(device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        yield


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]
            ) -> torch.Tensor:
    """flax ``Dropout``: keep each element with probability ``1 - rate``
    (a mask from a generator seeded with ``seed``) and scale it by
    ``1 / (1 - rate)``; the identity for ``seed`` None or rate 0."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _call(module: nn.Module, params: Dict[str, torch.Tensor], *args):
    return functional_call(module, params, args)


class _RematStage(nn.Module):
    """A stage of ``units`` modules ``unit_{u}`` over a (hidden, side)
    pair, applied functionally (:meth:`apply`) with each unit
    rematerialized."""

    def _unit_keys(self):
        keys = getattr(self, "_keys", None)
        if keys is None:
            names = [n for n, _ in self.named_parameters()]
            keys = [[(n, n[len(f"unit_{u}."):]) for n in names
                     if n.startswith(f"unit_{u}.")]
                    for u in range(self.units)]
            self._keys = keys
        return keys

    def apply(self, params: Dict[str, torch.Tensor], hidden, side,
              replay_rng: bool = False):
        """Each unit ``u`` on its slice of ``params`` (the stage's
        parameter names), under ``torch.utils.checkpoint`` (the unit's
        inputs kept, its forward re-run in the backward;
        ``replay_rng``: its generator state replayed there)."""
        for u, keys in enumerate(self._unit_keys()):
            unit = getattr(self, f"unit_{u}")
            local = {rest: params[full] for full, rest in keys}
            hidden, side = checkpoint(_call, unit, local, hidden, side,
                                      use_reentrant=False,
                                      preserve_rng_state=replay_rng)
        return hidden, side


class EncoderUnit(nn.Module):
    """One full encoder trio (attention + FFN)."""

    def __init__(self, config: Any, deterministic: bool = True):
        super().__init__()
        self.head = BertLayer_Head(config, deterministic)
        self.body = BertLayer_Body(config, deterministic)
        self.tail = BertLayer_Tail(config, deterministic)

    def forward(self, hidden, mask):
        hidden, mask = self.head(hidden, mask)
        inter, attn, mask = self.body(hidden, mask)
        return self.tail(inter, attn, mask)


class EncoderStage(_RematStage):
    """``units`` encoder trios = one uniform pipeline stage, each unit
    rematerialized (only each unit's input survives to the backward)."""

    def __init__(self, config: Any, units: int, deterministic: bool = True):
        super().__init__()
        self.units = units
        for u in range(units):
            self.add_module(f"unit_{u}", EncoderUnit(config, deterministic))


# --- tensor parallelism inside the stage ------------------------------------


def _tp_dense(xs, params, name: str, dtype, mode: str, devices):
    """``_TpDense`` at every tp position: ``col`` ``x @ W_t + b_t`` (the
    output features' shard, no collective); ``row`` the partial products
    ``x_t @ W_t`` summed over ``tp`` before the (replicated) bias."""
    w = [p[f"{name}.weight"].to(dtype) for p in params]
    if mode == "col":
        return [F.linear(x.to(dtype), wt, p[f"{name}.bias"].to(dtype))
                for x, wt, p in zip(xs, w, params)]
    parts = [F.linear(x.to(dtype), wt) for x, wt in zip(xs, w)]
    return [y + p[f"{name}.bias"].to(dtype)
            for y, p in zip(psum(parts, devices), params)]


def _tp_layer_norm(x, params, name: str, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), params[f"{name}.weight"],
                        params[f"{name}.bias"], eps)


def _check_tp(cfg, tp: int) -> None:
    if (cfg.hidden_size % tp or cfg.num_attention_heads % tp
            or cfg.intermediate_size % tp):
        raise ValueError(
            f"hidden/heads/intermediate ({cfg.hidden_size}/"
            f"{cfg.num_attention_heads}/{cfg.intermediate_size}) must all "
            f"be divisible by tp={tp}")


class TpEncoderUnit:
    """Megatron-style tensor-parallel encoder trio over lists indexed by
    the ``tp`` position: q/k/v and the FFN up-projection column-parallel
    (heads split across tp), the attention output and the FFN
    down-projection row-parallel with a sum over tp; LayerNorms and
    residuals replicated.  Parameter names are :class:`EncoderUnit`'s,
    with tp-local shapes.

    Dropout follows Megatron's discipline: masks on replicated
    activations (after a row-parallel sum) equal across tp, the
    attention-probs mask (head-sharded) folded by the tp position."""

    _SITES = ("attn_probs", "attn_out", "ffn_out")

    def __init__(self, config: Any, tp: int, deterministic: bool = True):
        self.cfg = cfg = BertConfig.from_dict(config)
        _check_tp(cfg, tp)
        self.tp = tp
        self.deterministic = deterministic

    def __call__(self, params, hidden, mask, devices, seed=None):
        cfg, tp = self.cfg, self.tp
        dt = torch_dtype(cfg.dtype)
        n_heads = cfg.num_attention_heads // tp
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        h_local = cfg.hidden_size // tp
        live = not self.deterministic and seed is not None

        def site(name, t=None):
            if not live:
                return None
            s = fold_seed(seed, self._SITES.index(name))
            return s if t is None else fold_seed(s, t)

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], n_heads, head_dim)

        q, k, v = (_tp_dense(hidden, params, f"head.self.{n}", dt, "col",
                             devices) for n in ("query", "key", "value"))
        ctx = []
        for t in range(tp):
            scores = torch.einsum("blhd,bmhd->bhlm", split(q[t]),
                                  split(k[t])) / torch.sqrt(torch.tensor(
                                      head_dim, dtype=dt,
                                      device=q[t].device))
            probs = torch.softmax((scores + mask[t]).float(), -1).to(dt)
            probs = dropout(probs, cfg.attention_probs_dropout_prob,
                            site("attn_probs", t))
            c = torch.einsum("bhlm,bmhd->blhd", probs, split(v[t]))
            ctx.append(c.reshape(c.shape[0], c.shape[1], h_local))
        y = _tp_dense(ctx, params, "head.output.dense", dt, "row", devices)
        attn = [_tp_layer_norm(
            dropout(yt, cfg.hidden_dropout_prob, site("attn_out")) + ht,
            p, "head.output.LayerNorm", 1e-12).to(dt)
            for yt, ht, p in zip(y, hidden, params)]
        act = ACT2FN[cfg.hidden_act]
        inter = [act(x) for x in _tp_dense(attn, params, "body.dense_act",
                                           dt, "col", devices)]
        y = _tp_dense(inter, params, "tail.dense", dt, "row", devices)
        out = [_tp_layer_norm(
            dropout(yt, cfg.hidden_dropout_prob, site("ffn_out")) + at,
            p, "tail.LayerNorm", 1e-12).to(dt)
            for yt, at, p in zip(y, attn, params)]
        return out, mask


class TpEncoderStage:
    """``units`` tensor-parallel units, each rematerialized; parameter
    names as :class:`EncoderStage`'s.  ``apply(params, hidden, side,
    devices, seed)`` takes and returns lists over the tp positions."""

    unit_cls = TpEncoderUnit

    def __init__(self, config: Any, units: int, tp: int,
                 deterministic: bool = True):
        self.units = [self.unit_cls(config, tp, deterministic)
                      for _ in range(units)]

    def apply(self, params, hidden, side, devices, seed=None):
        for u, unit in enumerate(self.units):
            prefix = f"unit_{u}."
            local = [{n[len(prefix):]: x for n, x in p.items()
                      if n.startswith(prefix)} for p in params]
            unit_seed = None if seed is None else fold_seed(seed, u)
            hidden, side = checkpoint(
                unit, local, hidden, side, devices, unit_seed,
                use_reentrant=False, preserve_rng_state=False)
        return hidden, side


def _role(name: str) -> Tuple[str, str]:
    parts = name.split(".")
    return parts[-2], parts[-1]  # (module, param), e.g. ('query', 'weight')


# module names whose dense layer is column- vs row-parallel, per family
BERT_TP_COL = ("query", "key", "value", "dense_act")
BERT_TP_ROW = ("dense",)


def tp_split_axis(name: str, col_modules, row_modules) -> Optional[int]:
    """Which axis of a stage leaf (port layout) splits across tp; None =
    replicate.  A role names a whole dense module or a ``(module,
    param)`` pair (a parameter of the module itself, e.g. an MoE expert
    tensor, kept in JAX's layout).  Column-parallel: a dense ``weight``
    [out, in] splits its output features (-2), a bias or a named
    parameter its last axis; row-parallel: a dense ``weight`` its input
    features (-1), a named parameter its second-to-last axis, and the
    row bias replicates (it is added after the sum)."""
    module, param = _role(name)
    if module in col_modules or (module, param) in col_modules:
        return -2 if (module in col_modules and param == "weight") else -1
    if (module, param) in row_modules:
        return -2
    if module in row_modules and param == "weight":
        return -1
    return None


def split_stage_params_for_tp(stages: Dict[str, torch.Tensor], tp: int,
                              col_modules=BERT_TP_COL,
                              row_modules=BERT_TP_ROW
                              ) -> Dict[str, torch.Tensor]:
    """``[P, ...full...]`` stacked stage leaves -> ``[P, tp,
    ...local...]``: column-parallel leaves slice their output features,
    row-parallel weights their input features; row biases, LayerNorms
    and routers replicate across tp."""
    out = {}
    for name, leaf in stages.items():
        ax = tp_split_axis(name, col_modules, row_modules)
        if ax is None:
            out[name] = leaf[:, None].expand(
                leaf.shape[0], tp, *leaf.shape[1:]).clone()
            continue
        k = ax % leaf.dim()
        shape = tuple(leaf.shape)
        parts = leaf.reshape(shape[:k] + (tp, shape[k] // tp) + shape[k + 1:])
        out[name] = torch.movedim(parts, k, 1).contiguous()
    return out


def merge_stage_params_from_tp(stages_tp: Dict[str, torch.Tensor],
                               col_modules=BERT_TP_COL,
                               row_modules=BERT_TP_ROW
                               ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_stage_params_for_tp`."""
    out = {}
    for name, leaf in stages_tp.items():
        ax = tp_split_axis(name, col_modules, row_modules)
        if ax is None:
            out[name] = leaf[:, 0].clone()
            continue
        k = ax % (leaf.dim() - 1)  # the axis in the merged leaf
        parts = torch.movedim(leaf, 1, k)
        shape = tuple(parts.shape)
        out[name] = parts.reshape(
            shape[:k] + (shape[k] * shape[k + 1],) + shape[k + 2:]).clone()
    return out


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _linear_weights(module: nn.Module, prefix: str = "") -> set:
    """Names of the ``nn.Linear`` weights of ``module`` (their layout is
    the transpose of JAX's kernels)."""
    return {f"{prefix}{name}.weight" if name else f"{prefix}weight"
            for name, sub in module.named_modules()
            if isinstance(sub, nn.Linear)}


class CompiledBertPipeline:
    """BERT classifier with the encoder pipelined across a ('pp',) mesh
    (optionally ('dp', 'pp') or ('dp', 'pp', 'tp'))."""

    tp_col_modules = BERT_TP_COL
    tp_row_modules = BERT_TP_ROW
    # engines whose stages accumulate a scalar into the ring's side
    # tensor (the MoE aux loss) carry it with the microbatch and return
    # (hidden, side)
    side_outputs = False
    _END_GROUPS = ("embeddings", "pooler", "classifier")
    _UNIT_LAYERS = ("head", "body", "tail")

    def __init__(self, config: Any, mesh, units_per_stage: int,
                 num_classes: int = 3,
                 num_microbatches: Optional[int] = None,
                 learning_rate: float = 1e-3, virtual_stages: int = 1,
                 optimizer=None, zero1: bool = False, zero2: bool = False,
                 zero3: bool = False, deterministic: bool = True):
        self.deterministic = bool(deterministic)
        self.cfg = self._parse_config(config)
        self.mesh = mesh
        self.num_stages = int(mesh.shape["pp"])
        self.virtual_stages = int(virtual_stages)
        if self.virtual_stages < 1:
            raise ValueError(
                f"virtual_stages must be >= 1, got {virtual_stages}")
        self.dp = int(mesh.shape.get("dp", 1))
        self.tp = int(mesh.shape.get("tp", 1))
        self.units_per_stage = units_per_stage
        self.num_classes = num_classes
        self.num_microbatches = num_microbatches or self.num_stages
        self.optimizer = optimizer_from(optimizer, learning_rate)
        self.zero1 = bool(zero1)
        if self.zero1 and self.dp == 1:
            raise ValueError("zero1 requires a 'dp' mesh axis of size > 1")
        self.zero2 = bool(zero2)
        if self.zero2 and not self.zero1:
            raise ValueError("zero2 extends zero1; pass zero1=True as well")
        self.zero3 = bool(zero3)
        if self.zero3 and self.dp == 1:
            raise ValueError("zero3 requires a 'dp' mesh axis of size > 1")
        self.home = (0,) * mesh.devices.ndim
        self.home_device = mesh.devices[self.home]
        with torch.device("meta"):
            self._build_modules(units_per_stage, num_classes)
        self._transposed = set()
        for group in self._END_GROUPS:
            self._transposed |= _linear_weights(getattr(self, group))
        self._transposed |= _linear_weights(self.stage)
        self.param_specs: Optional[Dict] = None
        self.opt_specs: Optional[Dict] = None
        self._zero3_axes: Dict[str, int] = {}
        self._train_step = None

    @staticmethod
    def _parse_config(config):
        return BertConfig.from_dict(config)

    def _build_modules(self, units_per_stage: int, num_classes: int) -> None:
        cfg = self.cfg.to_dict()
        det = self.deterministic
        self.embeddings = BertEmbeddings(cfg, deterministic=det)
        self.stage = EncoderStage(cfg, units_per_stage, deterministic=det)
        self.tp_stage = (TpEncoderStage(cfg, units_per_stage, self.tp,
                                        deterministic=det)
                         if self.tp > 1 else None)
        self.pooler = BertPooler(cfg, deterministic=det)
        self.classifier = BertTailForClassification(
            hidden_dropout_prob=self.cfg.hidden_dropout_prob,
            hidden_size=self.cfg.hidden_size, num_classes=num_classes,
            deterministic=det, dtype=self.cfg.dtype)

    @property
    def end_groups(self) -> Tuple[str, ...]:
        return self._END_GROUPS

    # --- layouts ---------------------------------------------------------------
    def position(self, pp: int, dp: int = 0, tp: int = 0) -> Tuple[int, ...]:
        """The mesh index of the (dp, pp, tp) position."""
        idx = {"dp": dp, "pp": pp, "tp": tp}
        return tuple(idx[a] for a in self.mesh.axis_names)

    def _pick_dp_axis(self, name: str, shape, first_axis: int) -> int:
        """The axis JAX's ``_pick_dp_axis`` picks, in this leaf's layout:
        the last dp-divisible axis at or after ``first_axis`` in JAX's
        order of the axes (a dense weight's last two axes are JAX's
        kernel's, swapped); -1 when none qualifies.  The one rule of
        ZeRO's state, gradient and parameter shards."""
        n = len(shape)
        order = list(range(n))
        if name in self._transposed and n - first_axis >= 2:
            order[-1], order[-2] = order[-2], order[-1]
        for jax_ax in range(n - 1, first_axis - 1, -1):
            ax = order[jax_ax]
            if shape[ax] % self.dp == 0 and shape[ax] >= self.dp:
                return ax
        return -1

    def _stage_dims(self) -> int:
        return 2 if self.tp > 1 else 1

    def _stage_spec(self, name: str, shape, with_dp: bool) -> tuple:
        stage_dims = self._stage_dims()
        spec = ["pp", "tp"][:stage_dims] + [None] * (len(shape) - stage_dims)
        if with_dp:
            ax = self._pick_dp_axis(name, shape, stage_dims)
            if ax >= 0:
                spec[ax] = "dp"
        return tuple(spec)

    def _end_spec(self, name: str, shape, with_dp: bool) -> tuple:
        spec = [None] * len(shape)
        if with_dp:
            ax = self._pick_dp_axis(name, shape, 0)
            if ax >= 0:
                spec[ax] = "dp"
        return tuple(spec)

    def _specs(self, tree, with_dp_stages: bool, with_dp_ends: bool):
        out = {}
        for group, leaves in tree.items():
            if group == "stages":
                out[group] = {n: self._stage_spec(n, t.shape, with_dp_stages)
                              for n, t in leaves.items()}
            else:
                out[group] = {n: self._end_spec(n, t.shape, with_dp_ends)
                              for n, t in leaves.items()}
        return out

    # --- init ------------------------------------------------------------------
    def _init_stages(self, seed: int) -> Dict[str, torch.Tensor]:
        """Stage leaves stacked on a leading S x V axis: stacked position
        p (device p // V, local slot p % V) holds model chunk (p % V) * S
        + p // V, each chunk drawn from its own seed; tp-split with a
        tp mesh axis."""
        S, V = self.num_stages, self.virtual_stages
        chunks = [init_state_dict(self.stage, torch.Generator().manual_seed(
            fold_seed(seed, 1000 + c))) for c in range(S * V)]
        order = [(p % V) * S + p // V for p in range(S * V)]
        stages = {name: torch.stack([chunks[c][name] for c in order])
                  for name in chunks[0]}
        if self.tp > 1:
            stages = split_stage_params_for_tp(
                stages, self.tp, self.tp_col_modules, self.tp_row_modules)
        return stages

    def init_tree(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The global tree :meth:`init` places: parameters drawn from
        ``seed`` as the JAX initializers draw them (N(0,
        initializer_range) dense and embedding weights, ``lecun_normal``
        for a dense layer without one, zero biases, unit LayerNorms),
        float32 on the CPU."""
        gen = torch.Generator().manual_seed(seed)
        tree = {"embeddings": init_state_dict(self.embeddings, gen),
                "stages": self._init_stages(seed)}
        for group in self.end_groups[1:]:
            tree[group] = init_state_dict(getattr(self, group), gen)
        return tree

    def init(self, seed: int, *sample_inputs):
        """:meth:`init_tree` placed on the mesh (:meth:`place`).  The
        sample inputs of JAX's signature are accepted and unused:
        PyTorch needs no shapes traced."""
        return self.place(self.init_tree(seed))

    def layer_state_dicts(self, tree) -> List[Dict[str, torch.Tensor]]:
        """A global tree without a tp split as the per-layer state dicts
        of the same model's ``LayerStack`` (``bert_layer_configs`` or
        ``gpt_layer_configs`` order): the embeddings, each chunk's units
        in model order (chunk c at stacked position (c % S) * V + c //
        S), the other ends."""
        if self.tp > 1:
            raise ValueError("merge the tp split first "
                             "(merge_stage_params_from_tp)")
        S, V = self.num_stages, self.virtual_stages
        out = [dict(tree["embeddings"])]
        for c in range(S * V):
            p = (c % S) * V + c // S
            for u in range(self.units_per_stage):
                for sub in self._UNIT_LAYERS:
                    prefix = f"unit_{u}.{sub}."
                    out.append({n[len(prefix):]: t[p]
                                for n, t in tree["stages"].items()
                                if n.startswith(prefix)})
        return out + [dict(tree[g]) for g in self.end_groups[1:]]

    def place(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        """A global tree (``{"embeddings": {name: tensor}, "stages":
        {name: [S*V, (tp,) ...]}, ...}``, the port's state-dict names and
        layouts, e.g. from :func:`~..convert.spmd_params_from_jax`) as
        this engine's parameters: a :class:`~.sharded.ShardedLeaf` per
        leaf, stage leaves over ``pp`` (and ``tp``; with ZeRO-3 one
        weight axis over ``dp``), the ends whole at every position."""
        self.param_specs = self._specs(tree, self.zero3, False)
        stage_dims = self._stage_dims()
        self._zero3_axes = {
            n: (spec.index("dp") - stage_dims if "dp" in spec else -1)
            for n, spec in self.param_specs["stages"].items()}
        return {group: {n: ShardedLeaf.place(
            torch.as_tensor(t), self.mesh, self.param_specs[group][n],
            requires_grad=True) for n, t in leaves.items()}
            for group, leaves in tree.items()}

    @staticmethod
    def gather(params) -> Dict[str, Dict[str, torch.Tensor]]:
        """The global tree of ``params`` (float32 CPU tensors)."""
        return {group: {n: leaf.gather() for n, leaf in leaves.items()}
                for group, leaves in params.items()}

    def init_opt_state(self, params) -> dict:
        """The optimizer's state (``count`` and its moments), laid out as
        the parameters, or with ZeRO-1 as ``dp`` shards: one
        dp-divisible axis of every leaf that has one (scalars and leaves
        without such an axis as the parameter)."""
        if self.zero1:
            shapes = map_tree(lambda leaf: torch.empty(leaf.shape,
                                                       device="meta"),
                              params)
            self.opt_specs = self._specs(shapes, True, True)
        else:
            self.opt_specs = map_tree(lambda leaf: leaf.spec, params)
        return init_state(self.optimizer, params, self.opt_specs)

    # --- the schedules -----------------------------------------------------------
    def _cells(self, M: int) -> List[Tuple[int, int, int, int]]:
        """The schedule's cells ``(tick, device d, local slot k,
        microbatch m)`` in tick order; chunk ``k * S + d``.  GPipe (V=1):
        stage d runs microbatch t - d at tick t.  Interleaved with M <=
        S (the wavefront): chunk c runs microbatch m at tick m + c.  With
        M > S (Megatron's grouped schedule) microbatches run in groups
        of S, M padded up to a multiple of S: device d at tick t maps
        tau = t - d to group tau // (V S), slot (tau mod V S) // S and
        offset tau mod S.  Idle cells and pads are left out."""
        S, V = self.num_stages, self.virtual_stages
        cells = []
        if V == 1:
            for t in range(M + S - 1):
                cells += [(t, d, 0, t - d) for d in range(S)
                          if 0 <= t - d < M]
            return cells
        C = S * V
        if M <= S:
            for t in range(M + C - 1):
                for d in range(S):
                    k = (t - d) // S
                    m = t - d - S * k
                    if 0 <= k < V and m < M:
                        cells.append((t, d, k, m))
            return cells
        padded = -(-M // S) * S
        for t in range(padded * V + S - 1):
            for d in range(S):
                tau = t - d
                if tau < 0:
                    continue
                g, r = divmod(tau, V * S)
                k, i = divmod(r, S)
                m = g * S + i
                if m < M:
                    cells.append((t, d, k, m))
        return cells

    def _chunk_params(self, stages, pos, k: int, cache) -> Dict:
        """The parameters of local slot ``k`` at ``pos`` (views of the
        local leaves); with ZeRO-3 each dp-sharded leaf gathered over
        ``dp`` onto ``pos``'s device (the gather's backward returns each
        shard its gradient)."""
        key = (pos, k)
        if cache is not None and key in cache:
            return cache[key]
        dev = self.mesh.devices[pos]
        dp_ax = (self.mesh.axis_names.index("dp")
                 if "dp" in self.mesh.axis_names else None)
        out = {}
        for name, leaf in stages.items():
            ax = self._zero3_axes.get(name, -1) if self.zero3 else -1

            def local(p):
                x = leaf.shards[p][k]
                return x[0] if self.tp > 1 else x

            if ax < 0:
                out[name] = local(pos)
            else:
                parts = [local(pos[:dp_ax] + (e,) + pos[dp_ax + 1:]).to(dev)
                         for e in range(self.dp)]
                out[name] = torch.cat(parts, ax)
        if cache is not None:
            cache[key] = out
        return out

    def _cell_seed(self, ring_seed: Optional[int], d: int, e: int, t: int):
        if ring_seed is None:
            return None
        base = fold_seed(ring_seed, d)
        if self.dp > 1:
            base = fold_seed(base, e)
        return fold_seed(base, t)

    def _run_cell(self, stages, d, k, e, hidden, side, seed, cache):
        """Chunk slot ``k`` of pp position ``d`` on dp row block ``e``:
        the inputs moved to the cell's position (each tp position's
        copy), the stage applied there."""
        if self.tp == 1:
            pos = self.position(d, e)
            dev = self.mesh.devices[pos]
            params = self._chunk_params(stages, pos, k, cache)
            live = seed is not None and not self.deterministic
            with seeded(seed if live else None, dev):
                return self.stage.apply(params, hidden.to(dev),
                                        side.to(dev), replay_rng=live)
        poss = [self.position(d, e, t) for t in range(self.tp)]
        devs = [self.mesh.devices[p] for p in poss]
        params = [self._chunk_params(stages, p, k, cache) for p in poss]

        def spread(x):
            xs = x if isinstance(x, list) else [x] * self.tp
            return [xt.to(dv) for xt, dv in zip(xs, devs)]

        return self.tp_stage.apply(params, spread(hidden), spread(side),
                                   devs, seed)

    def _encoder(self, stages, hidden_mb, side_mb, ring_seed=None):
        """The pipelined encoder: [M, mb, ...] -> [M, mb, ...] on the
        first position (with ``side_outputs``, a (hidden, side) pair).
        Activations are row-sharded over ``dp``; each cell's output
        moves to the next chunk's position."""
        S, V, dp = self.num_stages, self.virtual_stages, self.dp
        C = S * V
        M, mb = hidden_mb.shape[0], hidden_mb.shape[1]
        if mb % dp:
            raise ValueError(f"microbatch size {mb} not divisible by "
                             f"dp={dp}")
        rows = mb // dp
        # GPipe reuses each position's parameters for all microbatches;
        # interleaved ZeRO-3 gathers the chunk in use at every tick
        cache = None if (self.zero3 and V > 1) else {}
        carry: Dict[Tuple[int, int], tuple] = {}
        done: Dict[int, int] = {}
        for t, d, k, m in self._cells(M):
            c = k * S + d
            if done.get(m, -1) != c - 1:
                raise RuntimeError(f"schedule fault: chunk {c} of "
                                   f"microbatch {m} at tick {t}")
            done[m] = c
            for e in range(dp):
                block = slice(e * rows, (e + 1) * rows)
                if c == 0:
                    h, s = hidden_mb[m, block], side_mb[m, block]
                else:
                    h, s = carry[(m, e)]
                    if not self.side_outputs:
                        s = side_mb[m, block]
                carry[(m, e)] = self._run_cell(
                    stages, d, k, e, h, s, self._cell_seed(ring_seed, d, e, t),
                    cache)
        home = self.home_device

        def first(x):
            return (x[0] if isinstance(x, list) else x).to(home)

        hidden = torch.stack([torch.cat([first(carry[(m, e)][0])
                                         for e in range(dp)])
                              for m in range(M)])
        if not self.side_outputs:
            return hidden
        side = torch.stack([torch.cat([first(carry[(m, e)][1])
                                       for e in range(dp)])
                            for m in range(M)])
        return hidden, side

    def _check_rng(self, rng):
        """Stochastic engines require a seed; deterministic ones ignore
        it."""
        if self.deterministic:
            return None
        if rng is None:
            raise ValueError(
                "this engine was built with deterministic=False (dropout "
                "active); pass rng= to train_step/loss/_logits")
        return int(rng)

    def _ends(self, params, group: str) -> Dict[str, torch.Tensor]:
        return {n: leaf.shards[self.home]
                for n, leaf in params[group].items()}

    def _split_batch(self, x: torch.Tensor) -> torch.Tensor:
        M = self.num_microbatches
        B = x.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        if (B // M) % self.dp != 0:
            raise ValueError(
                f"microbatch size {B // M} not divisible by dp={self.dp}")
        return x.reshape(M, B // M, *x.shape[1:])

    # --- full model --------------------------------------------------------------
    def _logits(self, params, input_ids, token_type_ids, attention_mask,
                rng=None):
        rng = self._check_rng(rng)
        dev = self.home_device

        def sub(i):
            return None if rng is None else fold_seed(rng, i)

        ids, types, mask = (_as_tensor(x, dev) for x in
                            (input_ids, token_type_ids, attention_mask))
        with seeded(sub(0), dev):
            hidden, mask4 = _call(self.embeddings,
                                  self._ends(params, "embeddings"),
                                  ids, types, mask)
        B = hidden.shape[0]
        encoded = self._encoder(params["stages"], self._split_batch(hidden),
                                self._split_batch(mask4), sub(1))
        encoded = encoded.reshape(B, *encoded.shape[2:])
        with seeded(sub(2), dev):
            pooled = _call(self.pooler, self._ends(params, "pooler"),
                           encoded, mask4)
        with seeded(sub(3), dev):
            return _call(self.classifier, self._ends(params, "classifier"),
                         pooled)

    def loss(self, params, batch, labels, rng=None):
        input_ids, token_type_ids, attention_mask = batch
        logits = self._logits(params, input_ids, token_type_ids,
                              attention_mask, rng=rng)
        return F.cross_entropy(logits.float(),
                               _as_tensor(labels, logits.device).long())

    # --- training ----------------------------------------------------------------
    def _guard_tp_replicated(self, stages) -> None:
        """Give every tp copy of a replicated stage leaf (a LayerNorm, a
        row bias, a router) the sum of the copies' gradients, as JAX's
        ``_psum_grad_tp`` does: each copy's backward saw only its own
        position's share of the uses."""
        if self.tp == 1:
            return
        tp_ax = self.mesh.axis_names.index("tp")
        for name, leaf in stages.items():
            if tp_split_axis(name, self.tp_col_modules,
                             self.tp_row_modules) is not None:
                continue
            for pos in leaf.shards:
                group = [leaf.shards[pos[:tp_ax] + (t,) + pos[tp_ax + 1:]]
                         for t in range(self.tp)]
                if pos[tp_ax] != 0 or all(x.grad is None for x in group):
                    continue
                grads = [torch.zeros_like(x) if x.grad is None else x.grad
                         for x in group]
                for x, g in zip(group, psum(grads,
                                            [x.device for x in group])):
                    x.grad = g

    def value_and_grad(self, params, batch, labels, rng=None):
        """(loss, gradient tree): the loss and its gradient in the
        parameters' global layout (float32 CPU tensors, as
        :meth:`gather` gives the parameters), each shard's summed over
        its replicas."""
        loss = self.loss(params, batch, labels, rng)
        loss.backward()
        self._guard_tp_replicated(params["stages"])
        grads = iter(reduce_gradients(leaves_of(params)))
        out = {}
        for group, leaves in params.items():
            out[group] = {}
            for name, leaf in leaves.items():
                g = next(grads)
                full = torch.empty(leaf.shape)
                for pos, t in g.items():
                    full[leaf.slices(pos)] = t.detach().cpu()
                out[group][name] = full
        return loss.detach(), out

    def make_train_step(self):
        """The train step: the loss, its backward through every
        position, each shard's gradient summed over its replicas (with
        ZeRO-2 only its state's region kept), the optimizer's update."""
        if self.zero1 and (self.param_specs is None
                           or self.opt_specs is None):
            raise RuntimeError(
                "zero1=True needs init() and init_opt_state() before "
                "make_train_step() — the step updates the shards those "
                "calls lay out")
        if self.zero3 and self.param_specs is None:
            raise RuntimeError(
                "zero3=True needs init() before make_train_step() — the "
                "step updates the parameters' dp shards")

        def train_step(params, opt_state, batch, labels, rng=None):
            loss = self.loss(params, batch, labels, rng)
            loss.backward()
            self._guard_tp_replicated(params["stages"])
            slots = self.optimizer.slots
            state_like = (leaves_of(opt_state[slots[0]])
                          if self.zero2 and slots else None)
            grads = reduce_gradients(leaves_of(params), state_like)
            apply_updates(self.optimizer, params, opt_state, grads)
            return params, opt_state, loss.detach()

        self._train_step = train_step
        return train_step

    def train_step(self, params, opt_state, batch, labels, rng=None):
        if self._train_step is None:
            self.make_train_step()
        if self.deterministic and rng is not None:
            raise ValueError(
                "rng= was passed but this engine is deterministic; build "
                "it with deterministic=False to train with dropout")
        self._check_rng(rng)
        return self._train_step(params, opt_state, batch, labels, rng)


__all__ = [
    "BERT_TP_COL",
    "BERT_TP_ROW",
    "CompiledBertPipeline",
    "EncoderStage",
    "EncoderUnit",
    "TpEncoderStage",
    "TpEncoderUnit",
    "dropout",
    "fold_seed",
    "merge_stage_params_from_tp",
    "seeded",
    "split_stage_params_for_tp",
    "tp_split_axis",
]
