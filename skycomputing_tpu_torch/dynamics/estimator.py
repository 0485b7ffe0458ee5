"""Static and timed measurement helpers (the port of
``skycomputing_tpu/dynamics/estimator.py``).

- FLOPs: one forward of the unit on the ``meta`` device (no parameter
  is materialized, nothing is computed) under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  products (matmuls, convolutions, attention), plus a count of the
  elementwise work it does not see, so that no unit profiles at 0: one
  FLOP per output element of every pointwise op (adds, activations,
  the mask arithmetic), 8 per element of a LayerNorm and 5 per element
  of a softmax.  XLA's cost model, which the JAX package reads, counts
  elementwise work too (its erf-gelu at tens of FLOPs per element), so
  the two agree per unit to within the ratio
  ``tests/test_torch_dynamics.py`` states.  On ``meta`` the flash
  attention wrapper takes its plain version, so the attention products
  are counted.
- Memory: the reference's formula over tensor shapes exactly — inputs +
  2 x outputs + ``param_scale`` x parameters, at 4 bytes a number, in
  MB.
- Time: warm-up first, then timed loops, each closed by
  ``torch.cuda.synchronize`` on a CUDA device, so a window holds the
  work it launched and nothing else.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence, Tuple

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
    aten.native_layer_norm: 8,
    aten._softmax: 5,
    aten._to_copy: 1,
}


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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        per = _ELEMENT_FLOPS.get(func.overloadpacket)
        if per is None and torch.Tag.pointwise in func.tags:
            per = 1
        if per:
            first = next((t for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)
                          and t.is_floating_point()), None)
            if first is not None:
                self.flops += per * first.numel()
        return out


def count_flops(module, inputs: Sequence[torch.Tensor]):
    """(outputs, products + elementwise FLOPs) of one forward."""
    elementwise = _ElementwiseFlops()
    with FlopCounterMode(display=False) as products, elementwise:
        out = module(*inputs)
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
    def benchmark_decode_step(*args, **kwargs):
        raise NotImplementedError(
            "Estimator.benchmark_decode_step is not ported to PyTorch yet (a "
            "later slice: the serving allocation, with "
            "Allocator.serving_allocate)"
        )


__all__ = ["Estimator", "count_flops", "memory_mb", "meta_like",
           "synchronize"]
