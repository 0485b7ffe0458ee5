"""Static and timed measurement helpers (the port of
``skycomputing_tpu/dynamics/estimator.py``).

- FLOPs: one forward (or, for serving, one decode step) of the unit on
  the ``meta`` device (no parameter is materialized, nothing is
  computed) under ``torch.utils.flop_counter.FlopCounterMode``, which
  counts the products (matmuls, convolutions, attention), plus a count
  of the work it does not see, charged as XLA's cost model charges the
  reference on the CPU, where the JAX package reads it: one FLOP per
  output element of every pointwise op (adds, the mask arithmetic), 7
  per element of a LayerNorm, 5 of a softmax, 64 of the erf-gelu; a
  dropout in train mode dispatches, on ``meta``, to ``bernoulli_`` (the
  mask), then ``div_`` and ``mul`` (1 each), and its mask costs 55 per
  element (``jax.random.bernoulli``'s threefry bits, the float
  conversion and the compare).  A layout copy (``clone``, einsum's
  contiguous operand) is a move and costs nothing.  XLA's CPU backend
  computes bfloat16 in float32, so in bf16 every operand of a product
  or an elementwise op converts up and every result converts back, one
  FLOP an element each; a write into a bf16 slab (the KV cache) converts
  the slab back; and an embedding lookup whose rows are cast to bf16
  costs two FLOPs per table element, the cast of the whole table that
  flax's ``Embed(dtype=...)`` makes.  Every embedding lookup is XLA's
  gather: one FLOP per element it returns (the out-of-bounds fill's
  select) and 6 per index (the bounds test).  A convolution costs 2
  FLOPs per multiply-add of each kernel tap that lands inside the input
  (XLA leaves out the taps over the padding, which the products counter
  counts), a GroupNorm 6 per element and 7 per (sample, group), a mean
  or a sum 1 per element it reads.  So the two agree per unit to
  within the ratios ``tests/test_torch_dynamics.py`` (training) and
  ``tests/test_torch_serving_alloc.py`` (decode) state.  On ``meta`` the
  flash attention wrapper runs its plain version over one grid cell of
  the JAX kernel, the work XLA's cost analysis charges the kernel's
  interpret-mode loop on the CPU.
- Backward and update (a whole train step, :func:`count_flops` over a
  function that calls ``backward`` and steps an optimizer, as
  ``utils.profiling.compiled_cost`` does): the products of autograd's
  backward are counted as the forward's are; its elementwise ops at
  what XLA charges them inside a compiled float32 train step, where
  the backward shares the forward's values: 37 FLOPs per element of
  the erf-gelu's derivative, 25 of a LayerNorm's, 5 of a softmax's,
  and one per row element an embedding's gradient scatters.  An add
  or a subtract with a scale (``alpha``, the SGD update ``p - lr *
  g``) is a multiply and an add, 2 per element, as optax's update is;
  a ``_foreach_`` op counts every tensor of its list.  So the count
  of BERT ``tiny``'s float32 train step is within 1% of XLA's
  (``tests/test_torch_profiling.py``); in bfloat16 XLA's CPU backend
  also charges the converts of the backward, which the count leaves
  out (about 12% of the tiny step).
- Memory: the reference's formula over tensor shapes exactly — inputs +
  2 x outputs + ``param_scale`` x parameters, at 4 bytes a number, in
  MB.
- Time: warm-up first, then timed loops, each closed by
  ``torch.cuda.synchronize`` on a CUDA device, so a window holds the
  work it launched and nothing else.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..utils import resolve_device

_MB = 1024.0 ** 2
aten = torch.ops.aten

# FLOPs per output element of the elementwise ops that are not tagged
# pointwise (a pointwise op counts 1)
_ELEMENT_FLOPS = {
    aten.native_layer_norm: 7,
    aten._softmax: 5,
    aten._to_copy: 1,
    aten.bernoulli_: 55,  # a dropout mask, as XLA counts it
    aten.clone: 0,  # a layout copy (einsum's contiguous operand): a move
    aten.gelu: 64,  # the erf form, as XLA counts it
    # backward ops, as XLA charges them in a compiled train step
    aten.gelu_backward: 37,
    aten.native_layer_norm_backward: 25,
    aten._softmax_backward_data: 5,
}
# an add or subtract with a scale: a multiply and an add per element
_SCALED = {aten.add, aten.add_, aten.sub, aten.sub_}
# XLA's GroupNorm (flax's): the square, the two reductions, the centring,
# the scaling by the inverse deviation, the scale and the offset cost 6
# FLOPs per element, and the statistics 7 per (sample, group)
_GROUP_NORM_FLOPS = (6, 7)


def _valid_taps(size: int, out: int, kernel: int, stride: int, pad: int,
                dilation: int) -> int:
    """Kernel taps over all ``out`` output positions of one spatial
    dimension that land inside the input (not in the padding)."""
    return sum(1 for o in range(out) for t in range(kernel)
               if 0 <= o * stride - pad + t * dilation < size)


def _conv_correction(args, out) -> int:
    """XLA's count of a convolution less ``FlopCounterMode``'s: XLA
    charges 2 FLOPs per multiply-add of a kernel tap that lands inside
    the input, PyTorch's counter every tap, padding included."""
    x, w = args[0], args[1]
    stride, pad, dilation, transposed = args[3], args[4], args[5], args[6]
    if transposed:
        return 0
    # w.shape[1] is the input channels of one group: the counters agree
    n, c_out, c_in = x.shape[0], w.shape[0], w.shape[1]
    taps = every = 1
    for d, k in enumerate(w.shape[2:]):
        taps *= _valid_taps(x.shape[2 + d], out.shape[2 + d], k, stride[d],
                            pad[d], dilation[d])
        every *= out.shape[2 + d] * k
    return 2 * n * c_out * c_in * (taps - every)


# XLA's CPU backend, on which the reference's cost model ran, computes
# bfloat16 arithmetic in float32: every bf16 operand of a product or an
# elementwise op converts up and every bf16 result converts back (one
# FLOP an element each), and a write into a bf16 slab converts the whole
# slab back
_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_HALF_WRITES = {aten.scatter_, aten.index_copy_}
# a view that picks part of a bf16 tensor: XLA converts the whole source
# up before it slices (BERT's pooler reads token 0 of its bf16 input)
_HALF_VIEWS = {aten.select}
# a table lookup whose rows are then cast to bf16: the reference casts
# the whole table first (flax's Embed(dtype=...))
_LOOKUPS = {aten.embedding}


def _half_numel(tensors) -> int:
    return sum(t.numel() for t in tensors if t.dtype == torch.bfloat16)


def _as_tuple(data) -> Tuple:
    return data if isinstance(data, tuple) else (data,)


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing off a card)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def meta_like(x) -> torch.Tensor:
    """An empty ``meta`` tensor of ``x``'s shape and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    x = np.asarray(x)
    dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
    return torch.empty(x.shape, dtype=dtype, device="meta")


def _bytes_at_4(tensors) -> float:
    return 4.0 * sum(float(t.numel()) for t in tensors)


def memory_mb(inputs, outputs, module, param_scale: int = 2) -> float:
    """The reference accounting formula: inputs + 2 x outputs +
    ``param_scale`` x parameters, 4 bytes a number, in MB."""
    outs = [t for t in tree_leaves(outputs) if isinstance(t, torch.Tensor)]
    return (_bytes_at_4(inputs) / _MB + 2.0 * _bytes_at_4(outs) / _MB
            + param_scale * _bytes_at_4(module.parameters()) / _MB)


class _ElementwiseFlops(TorchDispatchMode):
    """Counts FLOPs of the elementwise ops (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        # id(rows) -> (rows, table elements) of each embedding lookup
        self._lookups = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _LOOKUPS:
            self._lookups[id(out)] = (out, args[0].numel())
            # XLA's gather: a select per row element (the out-of-bounds
            # fill) and a bounds test of 6 per index
            self.flops += out.numel() + 6 * args[1].numel()
        elif packet is aten._to_copy and id(args[0]) in self._lookups \
                and out.dtype == torch.bfloat16:
            # XLA charges the table's cast both ways on its CPU backend
            self.flops += 2 * self._lookups[id(args[0])][1]
        elif packet is aten.convolution:
            self.flops += _conv_correction(args, out)
        elif packet is aten.native_group_norm:
            per_element, per_group = _GROUP_NORM_FLOPS
            self.flops += (per_element * out[0].numel()
                           + per_group * out[1].numel())
        elif packet in (aten.mean, aten.sum):
            # XLA's reduce: one add per element it reads
            self.flops += args[0].numel()
        elif packet is aten.embedding_dense_backward:
            # XLA's scatter-add: one add per row element it scatters
            self.flops += args[0].numel()
        if func.name().startswith("aten::_foreach_"):
            # a list op: every tensor of the list (the result, or the
            # first argument of an in-place op)
            per = 2 if (kwargs or {}).get("alpha", 1) != 1 else 1
            listed = out if out else args[0]
            self.flops += per * sum(t.numel() for t in tree_leaves(listed)
                                    if isinstance(t, torch.Tensor))
            return out
        per = _ELEMENT_FLOPS.get(packet)
        pointwise = torch.Tag.pointwise in func.tags
        if per is None and pointwise:
            per = 1
        if packet in _SCALED and (kwargs or {}).get("alpha", 1) != 1:
            per = 2
        first = next((t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)
                      and t.is_floating_point()), None)
        if per and first is not None:
            self.flops += per * first.numel()
        if packet in _HALF_VIEWS:
            self.flops += _half_numel([args[0]])
        elif packet in _HALF_WRITES:
            # the slab converts back after the write (its reader, a
            # product, pays the convert up)
            self.flops += _half_numel([args[0]])
        elif pointwise or packet in _PRODUCTS:
            # each half-precision operand converts up, a half result
            # converts back
            self.flops += _half_numel(
                [a for a in args if isinstance(a, torch.Tensor)
                 and a.dim() > 0] + ([first] if first is not None else []))
        return out


def count_flops(fn, inputs: Sequence[torch.Tensor]):
    """(outputs, products + elementwise FLOPs) of one call of ``fn`` (a
    module's forward, or a method such as a unit's ``decode``)."""
    elementwise = _ElementwiseFlops()
    with FlopCounterMode(display=False) as products, elementwise:
        out = fn(*inputs)
    return out, float(products.get_total_flops() + elementwise.flops)


class Estimator:
    """Stateless measurement helpers (a namespace class, as in JAX)."""

    @staticmethod
    def benchmark_speed(fn: Callable, args: Sequence[Any], device=None,
                        iterations: int = 30, warmup: int = 3) -> float:
        """Total seconds of ``iterations`` calls of ``fn(*args)`` after
        ``warmup`` calls, the window closed by a synchronize.  ``device``
        None is the card (raising where there is none)."""
        device = resolve_device(device)
        args = [torch.as_tensor(a, device=device) for a in args]
        with torch.no_grad():
            for _ in range(max(warmup, 1)):
                fn(*args)
            synchronize(device)
            start = time.perf_counter()
            for _ in range(iterations):
                fn(*args)
            synchronize(device)
        return time.perf_counter() - start

    @staticmethod
    def benchmark_model(module, data: Sequence[Any], param_scale: int = 2):
        """(output meta tensors, FLOPs, mem_MB) for one unit — static:
        ``module`` is best built on the ``meta`` device, and ``data``
        (arrays, tensors or meta tensors) only gives shapes and dtypes."""
        inputs = tuple(meta_like(x) for x in _as_tuple(data))
        module = module.to("meta")
        out, flops = count_flops(module, inputs)
        return out, flops, memory_mb(inputs, out, module, param_scale)

    @staticmethod
    def estimate_memory(module, data: Sequence[Any], param_scale: int = 2):
        """(output meta tensors, mem_MB): the memory half of
        :meth:`benchmark_model`, without counting FLOPs."""
        inputs = tuple(meta_like(x) for x in _as_tuple(data))
        module = module.to("meta")
        with torch.no_grad():
            out = module(*inputs)
        return out, memory_mb(inputs, out, module, param_scale)

    @staticmethod
    def benchmark_train_time(module, data: Sequence[Any], device=None,
                             iterations: int = 8, warmup: int = 2,
                             repeats: int = 3) -> Tuple[Any, float]:
        """(outputs, measured forward + backward seconds per iteration)
        of one unit with its real weights on ``device``.

        An iteration is what a pipeline stage computes for a microbatch:
        the forward, then a backward against a full-size ones cotangent
        for every floating output, with respect to the parameters and
        the floating inputs (integer inputs such as token ids pass
        through).  After ``warmup`` iterations, the best of ``repeats``
        loops of ``iterations``, each closed by a synchronize.  The
        outputs are the forward's, detached, for the next unit.
        ``device`` None is the card (raising where there is none)."""
        device = resolve_device(device)
        module = module.to(device)
        xs = [torch.as_tensor(x, device=device) for x in _as_tuple(data)]

        def step():
            ins = [x.detach().requires_grad_(x.is_floating_point())
                   for x in xs]
            outs = [o for o in tree_leaves(module(*ins))
                    if isinstance(o, torch.Tensor)
                    and o.is_floating_point() and o.requires_grad]
            torch.autograd.backward(outs, [torch.ones_like(o)
                                           for o in outs])

        with torch.enable_grad():
            for _ in range(max(warmup, 1)):
                step()
            synchronize(device)
            best = float("inf")
            for _ in range(repeats):
                start = time.perf_counter()
                for _ in range(iterations):
                    step()
                synchronize(device)
                best = min(best, (time.perf_counter() - start) / iterations)
        module.zero_grad(set_to_none=True)
        with torch.no_grad():
            outputs = module(*xs)
        return outputs, best

    @staticmethod
    def benchmark_decode_step(module, data: Sequence[Any],
                              cache_avals: Optional[Sequence[Any]] = None,
                              index: Any = None, param_scale: int = 2):
        """(output meta tensors, FLOPs, mem_MB) for ONE decode iteration
        of a unit — static, the serving counterpart of
        :meth:`benchmark_model`.  The unit runs on ``meta`` under the
        same FLOP counter:

        - attention units (``cache_avals`` given: the (k, v) slot slabs
          ``[S, max_len, heads, head_dim]``) run ``decode(data, k, v,
          index)`` against the full slabs;
        - units with a ``decode`` method (the embeddings) run
          ``decode(data, index)``;
        - every other unit runs ``forward``.

        ``mem_MB`` is the reference formula over the DATA outputs only:
        an attention decode also returns its caches, but they are the
        slabs it was given, written in place, not activations of the
        step.  The slab memory itself is a pool-level charge the serving
        profile adds (``serving/kv_cache.kv_mb_per_layer``), one formula
        shared with the pre-flight verifier."""
        inputs = tuple(meta_like(x) for x in _as_tuple(data))
        module = module.to("meta")
        if cache_avals is not None:
            args = inputs + tuple(meta_like(c) for c in cache_avals) + (
                meta_like(index),)
            fn = module.decode
        elif hasattr(module, "decode"):
            args, fn = inputs + (meta_like(index),), module.decode
        else:
            args, fn = inputs, module
        with torch.no_grad():
            out, flops = count_flops(fn, args)
        data_out = out[0] if cache_avals is not None else out
        return out, flops, memory_mb(inputs, data_out, module, param_scale)


__all__ = ["Estimator", "count_flops", "memory_mb", "meta_like",
           "synchronize"]
