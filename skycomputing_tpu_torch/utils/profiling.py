"""Profiling helpers (the port of ``skycomputing_tpu/utils/profiling.py``).

- :func:`trace` records a ``torch.profiler`` trace of the enclosed
  block (CPU activity, plus CUDA activity when a card is in use) and
  writes it as a Chrome trace into a directory;
- :func:`annotate` names a region on that timeline
  (``torch.profiler.record_function``);
- :func:`compiled_cost` is the cost of one call of a function: FLOPs
  from the port's counter (``dynamics/estimator.py:count_flops``) over
  the call run on ``meta`` tensors, bytes from the shapes, and the
  card's scratch memory over one real call.

What the JAX module has and this one does not: ``optimal_seconds``
(XLA's cost-model estimate of a compiled program's time; eager PyTorch
compiles no program to estimate) and ``normalize_cost_analysis`` (a
shim over the shapes ``cost_analysis()`` takes across JAX versions).
``bytes_accessed`` is the arguments read once and the outputs written
once; XLA's figure counts what its fusions touch, which eager PyTorch,
having no fusion, has no counterpart of, so the two are not held
against each other.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Any, Dict, List

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["annotate", "compiled_cost", "kernel_names", "trace"]


def _activities(cuda: bool) -> List[Any]:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = None):
    """Record a ``torch.profiler`` trace of the enclosed block and write
    it to ``log_dir/trace.json`` (Chrome trace format, readable in
    Perfetto).  ``cuda`` None records the card's activity whenever a
    card is present.  Yields the profiler; after the block,
    ``prof.key_averages()`` sums the recorded events by name."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(cuda))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region that shows on the profiler's timeline."""
    return torch.profiler.record_function(name)


def kernel_names(prof) -> List[str]:
    """The names of the device kernels a :func:`trace` recorded, one
    per distinct name, in order of first appearance."""
    seen: Dict[str, None] = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            seen.setdefault(ev.name, None)
    return list(seen)


def _meta_tensor(t: torch.Tensor) -> torch.Tensor:
    m = torch.empty(t.shape, dtype=t.dtype, device="meta")
    if isinstance(t, torch.nn.Parameter):
        return torch.nn.Parameter(m, requires_grad=t.requires_grad)
    return m.requires_grad_(t.requires_grad)


def _meta_module(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are ``meta``
    tensors of the same shapes: no weight is copied."""
    memo = {id(t): _meta_tensor(t)
            for t in list(module.parameters()) + list(module.buffers())}
    return copy.deepcopy(module, memo)


def _to_meta(x):
    if isinstance(x, torch.nn.Module):
        return _meta_module(x)
    if isinstance(x, torch.Tensor):
        return _meta_tensor(x)
    return x


def _nbytes(tree) -> float:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            tensors = list(x.parameters()) + list(x.buffers())
        elif isinstance(x, torch.Tensor):
            tensors = [x]
        else:
            tensors = []
        total += sum(t.numel() * t.element_size() for t in tensors)
    return float(total)


def _on_card(tree) -> bool:
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            x = next(iter(x.parameters()), None)
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return True
    return False


def compiled_cost(fn, *args) -> Dict[str, float]:
    """The cost of one call ``fn(*args)``, in the JAX function's keys.

    ``args`` are pytrees of tensors and modules (a module's parameters
    and buffers count as arguments, as a JAX function's params do);
    ``fn`` may itself be a module, whose weights then count so too.
    ``flops`` counts one call run on ``meta`` copies of them (a
    module's copy holds ``meta`` weights; nothing is computed), so a
    function that calls ``backward`` and steps an optimizer built
    inside it counts the whole train step.  ``argument_bytes`` and
    ``output_bytes`` come from the shapes, ``bytes_accessed`` is their
    sum.  Where an argument lies on the card, ``fn`` also runs once
    for real and ``temp_bytes`` is the card's peak allocation over
    that call above what was allocated before it (the arguments);
    off the card there is no such measurement and the key is absent,
    as JAX leaves it out where XLA has no memory analysis."""
    from ..dynamics.estimator import count_flops

    meta_args = tree_map(_to_meta, args)
    out, flops = count_flops(_to_meta(fn), meta_args)
    out_bytes = _nbytes(out)
    arg_bytes = _nbytes((fn, args))
    cost = {
        "flops": float(flops),
        "bytes_accessed": arg_bytes + out_bytes,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
    }
    if _on_card(args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn(*args)
        torch.cuda.synchronize()
        cost["temp_bytes"] = float(torch.cuda.max_memory_allocated()
                                   - before)
    return cost
