"""Tensors laid out over a :class:`~.mesh.Mesh` by a partition spec, and
the optimizers that update them (the single-controller counterpart of
JAX's ``NamedSharding`` arrays and of optax's ``sgd`` and ``adam`` as the
compiled engines use them).

A :class:`ShardedLeaf` is one logical tensor of a global ``shape``: its
``spec`` names, per dimension, the mesh axis that splits it (``None``:
whole), and ``shards[pos]`` is the local tensor at mesh position ``pos``
(an index into ``mesh.devices``), on that position's device.  A
dimension split over an axis of size n holds its ``i``-th n-th at the
positions whose index along that axis is ``i``; positions that differ
only along axes the spec does not name hold equal copies (replicas), as
JAX's ``addressable_shards`` do.  The local tensors have the shapes the
JAX array's shards have on the same positions.

Gradients follow the rule JAX's spec-driven transposes give: after a
backward, each position's local tensor holds the gradient of its own
uses; :func:`reduce_gradients` sums them over the replicas of each
shard (an explicit sum of the positions' partials, moved back to each
position).  That one rule is the ``dp`` sum of data parallelism, the
gradient of a replicated leaf of the monolithic tensor-parallel path,
and that of the ends the compiled engines compute once, at the mesh's
first position.  (A tensor-parallel stage's replicated leaves stack
their copies on a ``tp`` axis, as JAX's do; the engine sums those
copies' gradients first, JAX's ``_psum_grad_tp``.)  With
``state_like``, each
position keeps only the part of the sum that its optimizer state covers
(ZeRO-2's reduce-scatter).

:class:`Sgd` and :class:`Adam` are optax's ``sgd(lr)`` and ``adam(lr)``
at optax's defaults, applied in place on local tensors;
:func:`apply_updates` runs one over a list of leaves whose state may be
split further than the parameter (ZeRO-1: each position updates its
state's region, then the regions are gathered back into every copy).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Position = Tuple[int, ...]


def positions(mesh) -> List[Position]:
    """Every position of ``mesh``, in device-grid order."""
    return list(np.ndindex(mesh.devices.shape))


class ShardedLeaf:
    """One logical tensor on ``mesh`` (see the module docstring)."""

    def __init__(self, mesh, spec: Sequence[Optional[str]], shape,
                 shards: Dict[Position, torch.Tensor]):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(int(n) for n in shape)
        self.shards = shards

    @classmethod
    def place(cls, tensor: torch.Tensor, mesh, spec, requires_grad=False
              ) -> "ShardedLeaf":
        """``tensor`` (the global value) split by ``spec``, a float32
        copy of each position's part on its device."""
        spec = tuple(spec) + (None,) * (tensor.dim() - len(spec))
        leaf = cls(mesh, spec, tensor.shape, {})
        for dim, axis in enumerate(spec):
            if axis is not None and tensor.shape[dim] % mesh.shape[axis]:
                raise ValueError(
                    f"dimension {dim} of {tuple(tensor.shape)} does not "
                    f"split over {axis}={mesh.shape[axis]}")
        for pos in positions(mesh):
            local = tensor[leaf.slices(pos)].to(
                device=mesh.devices[pos], dtype=torch.float32, copy=True)
            leaf.shards[pos] = local.contiguous().requires_grad_(
                requires_grad)
        return leaf

    def zeros(self, spec=None) -> "ShardedLeaf":
        """A leaf of zeros with this one's shape, laid out by ``spec``
        (default this one's)."""
        return ShardedLeaf.place(torch.zeros(self.shape), self.mesh,
                                 self.spec if spec is None else spec)

    def slices(self, pos: Position) -> Tuple[slice, ...]:
        """The global index region held at ``pos``."""
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            size = self.shape[dim] // n
            i = pos[self.mesh.axis_names.index(axis)]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def key(self, pos: Position) -> tuple:
        """Which shard ``pos`` holds: equal keys are replicas."""
        return tuple(pos[self.mesh.axis_names.index(a)]
                     for a in self.spec if a is not None)

    def gather(self) -> torch.Tensor:
        """The global value, float32 on the CPU."""
        out = torch.empty(self.shape)
        for pos, local in self.shards.items():
            out[self.slices(pos)] = local.detach().cpu()
        return out

    def nbytes(self, pos: Position) -> int:
        t = self.shards[pos]
        return t.numel() * t.element_size()

    def __repr__(self) -> str:
        return f"ShardedLeaf(shape={self.shape}, spec={self.spec})"


def _items(tree):
    return enumerate(tree) if isinstance(tree, (list, tuple)) else \
        tree.items()


def leaves_of(tree) -> List[ShardedLeaf]:
    """The leaves of a nested dict (or list) of :class:`ShardedLeaf`, in
    order of insertion."""
    if isinstance(tree, ShardedLeaf):
        return [tree]
    out = []
    for _, value in _items(tree):
        out.extend(leaves_of(value))
    return out


def map_tree(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, ShardedLeaf):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return {k: map_tree(fn, v) for k, v in tree.items()}


def psum(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """The sum of the positions' ``parts`` (taken in position order on
    the first one's device), a copy moved to each of ``devices``: the
    single controller's ``lax.psum``."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x.to(total.device)
    return [total.to(d) for d in devices]


def _extra_axis(param: ShardedLeaf, state: ShardedLeaf):
    """(dim, axis) where ``state`` splits a dimension ``param`` holds
    whole (ZeRO's dp shard of a replicated parameter), else None."""
    for dim, (a, b) in enumerate(zip(param.spec, state.spec)):
        if a != b:
            if a is not None:
                raise ValueError(f"state spec {state.spec} does not refine "
                                 f"parameter spec {param.spec}")
            return dim, b
    return None


def _region(t: torch.Tensor, pos: Position, extra, mesh) -> torch.Tensor:
    dim, axis = extra
    n = mesh.shape[axis]
    size = t.shape[dim] // n
    return t.narrow(dim, pos[mesh.axis_names.index(axis)] * size, size)


def reduce_gradients(params: Sequence[ShardedLeaf],
                     state_like: Optional[Sequence[ShardedLeaf]] = None
                     ) -> List[Dict[Position, torch.Tensor]]:
    """Each leaf's gradient at each position: the sum over the replicas
    of the position's shard of the gradients left by the backward (a
    replica with none adds nothing; a shard no replica used gets zeros),
    summed on the shard's first replica's device in position order and
    moved back to each.  With ``state_like`` (ZeRO-2), a position keeps
    only the region its state leaf covers.  Clears the local
    gradients."""
    out = []
    for i, leaf in enumerate(params):
        groups = defaultdict(list)
        for pos in leaf.shards:
            groups[leaf.key(pos)].append(pos)
        extra = (None if state_like is None
                 else _extra_axis(leaf, state_like[i]))
        grads: Dict[Position, torch.Tensor] = {}
        for members in groups.values():
            parts = [leaf.shards[q].grad for q in members
                     if leaf.shards[q].grad is not None]
            total = (psum(parts, [parts[0].device])[0] if parts
                     else torch.zeros_like(leaf.shards[members[0]]))
            for q in members:
                dev = leaf.mesh.devices[q]
                if extra is None:
                    grads[q] = total.to(dev)
                else:
                    grads[q] = _region(total, q, extra, leaf.mesh).to(
                        dev, copy=True)
        for t in leaf.shards.values():
            t.grad = None
        out.append(grads)
    return out


class _Optimizer:
    slots: Tuple[str, ...] = ()

    def init(self, params, specs=None) -> dict:
        """This optimizer's state for the tree ``params``
        (:func:`init_state`)."""
        return init_state(self, params, specs)


class Sgd(_Optimizer):
    """optax ``sgd(learning_rate)``: ``p + (-lr * g)``."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def step_(self, p: torch.Tensor, g: torch.Tensor, state: dict,
              count: int) -> None:
        p.add_(g * -self.learning_rate)


class Adam(_Optimizer):
    """optax ``adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8)``: the
    moments ``mu``/``nu`` updated as ``(1 - b) * g + b * m``, bias
    corrected by ``1 - b ** count``, and ``p + -lr * mu_hat /
    (sqrt(nu_hat) + eps)``."""

    slots: Tuple[str, ...] = ("mu", "nu")

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def step_(self, p: torch.Tensor, g: torch.Tensor, state: dict,
              count: int) -> None:
        mu, nu = state["mu"], state["nu"]
        mu.mul_(self.b1).add_(g * (1.0 - self.b1))
        nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
        mu_hat = mu / (1.0 - self.b1 ** count)
        nu_hat = nu / (1.0 - self.b2 ** count)
        p.add_(-self.learning_rate * (mu_hat / (nu_hat.sqrt() + self.eps)))


def optimizer_from(optimizer=None, learning_rate: float = 1e-3):
    """An optimizer of this module from ``optimizer``: ``None`` (optax's
    ``sgd(learning_rate)``, the JAX engines' default) or an :class:`Sgd`
    or :class:`Adam`; anything else raises."""
    if optimizer is None:
        return Sgd(learning_rate)
    if isinstance(optimizer, (Sgd, Adam)):
        return optimizer
    raise TypeError(f"not an optimizer: {optimizer!r}")


def init_state(optimizer, params, specs=None) -> dict:
    """The optimizer's state for the tree ``params``: ``count`` (steps
    taken) and, per slot, a tree of zero leaves, each laid out by the
    spec at the same place in the tree ``specs`` (default the
    parameter's own)."""
    state = {"count": 0}
    for slot in optimizer.slots:
        state[slot] = _zip_tree(
            lambda p, spec: p.zeros(spec), params,
            specs if specs is not None else map_tree(lambda p: None, params))
    return state


def _zip_tree(fn, tree, other):
    if isinstance(tree, ShardedLeaf):
        return fn(tree, other)
    if isinstance(tree, (list, tuple)):
        return [_zip_tree(fn, v, other[i]) for i, v in enumerate(tree)]
    return {k: _zip_tree(fn, v, other[k]) for k, v in tree.items()}


def apply_updates(optimizer, params, state: dict,
                  grads: Sequence[Dict[Position, torch.Tensor]]) -> None:
    """One optimizer step in place over the tree ``params`` (``grads``
    in :func:`leaves_of` order, from :func:`reduce_gradients`).  Where
    the state splits a dimension the parameter holds whole (ZeRO-1),
    each position updates its state's region of its copy and every copy
    is then assembled from the regions of the positions along that axis
    (the all-gather); otherwise each position updates its local
    tensor."""
    state["count"] += 1
    count = state["count"]
    slots = optimizer.slots
    flat = leaves_of(params)
    slot_leaves = {s: leaves_of(state[s]) for s in slots}
    with torch.no_grad():
        for i, leaf in enumerate(flat):
            local_state = lambda pos: {s: slot_leaves[s][i].shards[pos]
                                       for s in slots}
            extra = (_extra_axis(leaf, slot_leaves[slots[0]][i]) if slots
                     else None)
            if extra is None:
                for pos, p in leaf.shards.items():
                    optimizer.step_(p, grads[i][pos], local_state(pos),
                                    count)
                continue
            regions = {}
            for pos, p in leaf.shards.items():
                region = _region(p, pos, extra, leaf.mesh).clone()
                g = grads[i][pos]
                if g.shape != region.shape:  # ZeRO-1: the whole sum
                    g = _region(g, pos, extra, leaf.mesh)
                optimizer.step_(region, g, local_state(pos), count)
                regions[pos] = region
            dim, axis = extra
            ax = leaf.mesh.axis_names.index(axis)
            for pos, p in leaf.shards.items():
                parts = [regions[pos[:ax] + (e,) + pos[ax + 1:]].to(p.device)
                         for e in range(leaf.mesh.shape[axis])]
                p.copy_(torch.cat(parts, dim))


__all__ = ["Adam", "Position", "Sgd", "ShardedLeaf", "apply_updates",
           "init_state", "leaves_of", "map_tree", "optimizer_from",
           "positions", "psum", "reduce_gradients"]
