"""Tensor parallelism for the monolithic model path (the port of
``skycomputing_tpu/parallel/tensor_parallel.py``).

Megatron-style intra-layer sharding of a :class:`~..builder.LayerStack`
over a ``('tp',)`` mesh: attention q/k/v and the FFN up-projection are
column-parallel (each position holds a block of output features), the
attention output and the FFN down-projection row-parallel (a block of
input features), everything else (biases, norms, embeddings) replicated
— the per-leaf specs of JAX's ``_spec_for``, in the port's ``[out, in]``
weight layout.  JAX annotates the parameters and lets GSPMD derive the
collectives; here they are written out: a column-parallel product runs
at every position on its weight block and the blocks are joined, a
row-parallel one splits its input, runs the partial products at every
position and sums them (on the first position, where the rest of each
layer runs) before the bias.  Gradients come back through those moves
and :func:`~.sharded.reduce_gradients` sums each replicated leaf's over
its copies.  TP inside the compiled pipeline lives in :mod:`.spmd`.
"""

from __future__ import annotations

import contextlib
import re
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .mesh import Mesh, make_1d_mesh
from .sharded import (
    ShardedLeaf,
    apply_updates,
    leaves_of,
    optimizer_from,
    psum,
    reduce_gradients,
)

# module-name patterns of 2-D dense weights: column-parallel (split output
# features) for QKV and FFN up, row-parallel (split input features) for
# the attention output projection and FFN down
_COLUMN = re.compile(r"(query|key|value|dense_act|c_fc|q_proj|k_proj|v_proj)$")
_ROW = re.compile(r"(dense|c_proj)$")


def make_tp_mesh(tp: int, devices: Optional[Sequence] = None) -> Mesh:
    return make_1d_mesh(tp, "tp", devices)


def _spec_for(name: str, leaf) -> tuple:
    if leaf.dim() != 2 or not name.endswith(".weight"):
        return ()  # biases, norms, embeddings stay replicated
    module_path = name[: -len(".weight")]
    if _COLUMN.search(module_path):
        return ("tp", None)  # [out, in]: split output features
    if _ROW.search(module_path):
        return (None, "tp")  # split input features
    return ()


def tp_shardings(params_list, mesh: Mesh) -> list:
    """Per-leaf partition specs (port layout) for a LayerStack's list of
    state dicts."""
    return [{name: _spec_for(name, torch.as_tensor(leaf))
             for name, leaf in params.items()} for params in params_list]


def shard_params(params_list, mesh: Mesh) -> list:
    """A LayerStack's state dicts placed under tensor-parallel specs: one
    dict of :class:`~.sharded.ShardedLeaf` per layer."""
    specs = tp_shardings(params_list, mesh)
    return [{name: ShardedLeaf.place(torch.as_tensor(leaf), mesh,
                                     spec[name], requires_grad=True)
             for name, leaf in params.items()}
            for params, spec in zip(params_list, specs)]


def _tp_linear(module: nn.Linear, weight: ShardedLeaf, bias: ShardedLeaf,
               x: torch.Tensor) -> torch.Tensor:
    mesh = weight.mesh
    home = (0,) * mesh.devices.ndim
    devices = list(mesh.devices.flatten())
    dt = getattr(module, "compute_dtype", x.dtype)
    tp = len(devices)
    pos = sorted(weight.shards)
    if weight.spec[0] == "tp":  # column-parallel
        n = weight.shape[0] // tp
        outs = []
        for t, p in enumerate(pos):
            b = bias.shards[p][t * n:(t + 1) * n]
            outs.append(F.linear(x.to(devices[t], dt),
                                 weight.shards[p].to(dt), b.to(dt)))
        return torch.cat([o.to(x.device) for o in outs], -1)
    n = weight.shape[1] // tp  # row-parallel
    parts = [F.linear(x[..., t * n:(t + 1) * n].to(devices[t], dt),
                      weight.shards[p].to(dt)) for t, p in enumerate(pos)]
    total = psum(parts, [x.device])[0]
    return total + bias.shards[home].to(dt)


@contextlib.contextmanager
def _tp_linears(module: nn.Module, params):
    """Every sharded dense submodule of ``module`` runs
    :func:`_tp_linear` over its leaves while the context is open."""
    patched = []
    for path, sub in module.named_modules():
        prefix = f"{path}." if path else ""
        weight = params.get(f"{prefix}weight")
        if (isinstance(sub, nn.Linear) and weight is not None
                and "tp" in weight.spec):
            bias = params[f"{prefix}bias"]
            sub.forward = (lambda x, s=sub, w=weight, b=bias:
                           _tp_linear(s, w, b, x))
            patched.append(sub)
    try:
        yield
    finally:
        for sub in patched:
            del sub.forward


def tp_apply(stack, params_list, *inputs):
    """``stack``'s forward on tensor-parallel parameters: each layer on
    the mesh's first position, with its sharded dense layers run over
    every position (:func:`_tp_linear`)."""
    first = next(iter(params_list[0].values()))
    home = (0,) * first.mesh.devices.ndim
    device = first.mesh.devices[home]
    data = tuple(torch.as_tensor(x).to(device) for x in inputs)
    out = data if len(data) > 1 else data[0]
    for module, params in zip(stack.layers, params_list):
        reps = {n: leaf.shards[home] for n, leaf in params.items()
                if "tp" not in leaf.spec}
        with _tp_linears(module, params):
            out = functional_call(module, reps, data, strict=False)
        data = out if isinstance(out, tuple) else (out,)
    return out


def tp_train_step_fn(stack, loss_fn, optimizer):
    """A ``(params_list, opt_state, batch, labels) -> (params_list,
    opt_state, loss)`` step for a monolithic model on tensor-parallel
    parameters (from :func:`shard_params`; ``opt_state`` from
    ``optimizer.init(params_list)``): the forward of :func:`tp_apply`,
    its backward, each leaf's gradient summed over its copies, the
    optimizer's update on every position's shard."""
    opt = optimizer_from(optimizer)

    def step(params_list, opt_state, batch, labels):
        logits = tp_apply(stack, params_list, *batch)
        loss = loss_fn(logits, torch.as_tensor(labels).to(logits.device))
        loss.backward()
        grads = reduce_gradients(leaves_of(params_list))
        apply_updates(opt, params_list, opt_state, grads)
        return params_list, opt_state, loss.detach()

    return step


__all__ = [
    "make_tp_mesh",
    "shard_params",
    "tp_apply",
    "tp_shardings",
    "tp_train_step_fn",
]
