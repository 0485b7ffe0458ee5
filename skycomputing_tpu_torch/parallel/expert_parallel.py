"""Expert parallelism: MoE expert weights split over an ``'ep'`` mesh
axis (the port of ``skycomputing_tpu/parallel/expert_parallel.py``).

The expert-stacked leaves of ``GptBlock_MoeMlp`` (``w1``, ``b1``, ``w2``,
``b2``, leading axis E) split over ``ep``: each position holds E/ep
experts; everything else replicates.  JAX leaves the exchange to XLA's
lowering of the dispatch and combine einsums; here it is written out
(:func:`ep_apply`): the router and dispatch run on the first position,
each position runs its experts on their buffers, combines their outputs
with their share of the combine weights, and the positions' partial
outputs are summed.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch.func import functional_call

from ..models.bert import ACT2FN
from ..models.gpt import GptBlock_MoeMlp
from ..ops.moe import expert_mlp, moe_combine, moe_dispatch, moe_route
from ..utils import torch_dtype
from .mesh import Mesh, make_1d_mesh
from .sharded import ShardedLeaf, psum

_EXPERT_LEAVES = {"w1", "b1", "w2", "b2"}


def make_ep_mesh(ep: int, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ('ep',) mesh over the first ``ep`` devices."""
    return make_1d_mesh(ep, "ep", devices)


def ep_shardings(params_list: List[Any], mesh: Mesh, axis: str = "ep"
                 ) -> list:
    """Per-leaf partition specs: expert-stacked leaves split their
    leading (expert) dimension over ``axis``, the rest replicate."""
    out = []
    for params in params_list:
        specs = {}
        for name, leaf in params.items():
            if name.split(".")[-1] in _EXPERT_LEAVES:
                n = torch.as_tensor(leaf).shape[0]
                if n % mesh.shape[axis] != 0:
                    raise ValueError(
                        f"num_experts {n} not divisible by "
                        f"{axis}={mesh.shape[axis]}")
                specs[name] = (axis,)
            else:
                specs[name] = ()
        out.append(specs)
    return out


def shard_moe_params(params_list: List[Any], mesh: Mesh, axis: str = "ep"
                     ) -> list:
    """A layer-indexed list of state dicts placed on the mesh with
    expert sharding: one dict of :class:`~.sharded.ShardedLeaf` per
    layer."""
    specs = ep_shardings(params_list, mesh, axis)
    return [{name: ShardedLeaf.place(torch.as_tensor(leaf), mesh, spec[name])
             for name, leaf in params.items()}
            for params, spec in zip(params_list, specs)]


def _ep_moe(module: GptBlock_MoeMlp, params, hidden):
    """``GptBlock_MoeMlp.forward`` with its experts split over the mesh:
    each position's experts on their buffers, combined with their share
    of the weights, the partial outputs summed."""
    cfg = module.config
    dt = torch_dtype(cfg.dtype)
    act = ACT2FN[cfg.hidden_act]
    w1 = params["w1"]
    mesh = w1.mesh
    home = (0,) * mesh.devices.ndim
    ln = params["ln_2.weight"].shards[home], params["ln_2.bias"].shards[home]
    x = torch.nn.functional.layer_norm(hidden.float(), hidden.shape[-1:],
                                       *ln, module.ln_2.eps).to(dt)
    tokens, dispatch, combine, aux = moe_route(
        x, params["router"].shards[home], module.num_experts, module.top_k,
        module.capacity_factor)
    module.aux_loss = aux.detach()
    expert_in = moe_dispatch(tokens, dispatch)
    parts = []
    for pos in sorted(w1.shards):
        sl = w1.slices(pos)[0]
        dev = mesh.devices[pos]
        local = [params[n].shards[pos].to(dt) for n in ("w1", "b1", "w2",
                                                        "b2")]
        y = expert_mlp(expert_in[sl].to(dev), *local, act)
        parts.append(moe_combine(combine[:, sl].to(dev), y))
    out = psum(parts, [hidden.device])[0]
    out = module.drop(out.reshape(hidden.shape).to(dt))
    if module.return_aux:
        return hidden + out, aux
    return hidden + out


def ep_apply(stack, params_list, *inputs):
    """``stack``'s forward on expert-parallel parameters (from
    :func:`shard_moe_params`): each layer on the mesh's first position,
    each MoE block's experts at their positions (:func:`_ep_moe`)."""
    first = next(iter(params_list[0].values()))
    home = (0,) * first.mesh.devices.ndim
    device = first.mesh.devices[home]
    data = tuple(torch.as_tensor(x).to(device) for x in inputs)
    out = data if len(data) > 1 else data[0]
    for module, params in zip(stack.layers, params_list):
        if isinstance(module, GptBlock_MoeMlp):
            out = _ep_moe(module, params, *data)
        else:
            reps = {n: leaf.shards[home] for n, leaf in params.items()}
            out = functional_call(module, reps, data)
        data = out if isinstance(out, tuple) else (out,)
    return out


__all__ = ["ep_apply", "ep_shardings", "make_ep_mesh", "shard_moe_params"]
