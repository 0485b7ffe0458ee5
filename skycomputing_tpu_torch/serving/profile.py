"""Decode-step cost and memory profiling for serving-balanced allocation
(the port of ``skycomputing_tpu/serving/profile.py``).

A partition balanced on TRAINING costs is wrong for serving: training
is a full-sequence forward and backward, where the FFN units outweigh
the attention units, while a decode step is one token against a
``max_len``-deep KV cache, whose read grows with ``max_len`` while the
FFN units shrink to ``Lq = 1`` products.  The memory picture flips too:
activations vanish, but every attention unit pins its KV cache for the
life of the engine.

:class:`DecodeModelBenchmarker` speaks the ``ModelBenchmarker``
interface (``benchmark() -> (per-unit costs, per-unit mem_MB)``), so
``Allocator.serving_allocate`` hands it to the same contiguous min-max
solver that balances training partitions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..dynamics.benchmarker import (
    BaseBenchmarker,
    _build_unit,
    _layer_key,
    _tensors,
)
from ..dynamics.estimator import Estimator
from ..utils import torch_dtype
from .kv_cache import kv_mb_per_layer, kv_spec_from_config, \
    paged_kv_mb_per_layer


class DecodeModelBenchmarker(BaseBenchmarker):
    """Per-unit DECODE-step cost and serving memory over a model config.

    ``cost[i]`` is the FLOPs of one decode iteration of unit ``i`` at
    the engine's operating point (``slots`` rows, ``max_len``-deep
    caches), counted by ``Estimator.benchmark_decode_step`` on ``meta``.
    ``mem[i]`` is the reference formula over the decode step's inputs,
    outputs and parameters PLUS the unit's KV memory: the slot slabs
    (:func:`~.kv_cache.kv_mb_per_layer`) or, with ``num_pages`` and
    ``page_size``, the page pool (:func:`~.kv_cache.paged_kv_mb_per_layer`,
    at ``kv_dtype``) — the formulas the pre-flight verifier charges, so
    the allocator and the verifier never disagree on it.

    Static (no parameter materialized, nothing computed) and deduped by
    (unit config, input signature), so a deep stack counts each distinct
    unit once.  On the paged path ``slots`` is the decode-row count and
    ``max_len`` the per-request span: they fix the step's compute, and
    only the memory charge changes to the pool's.
    """

    def __init__(
        self,
        model_config: List[Dict],
        *,
        slots: int,
        max_len: int,
        param_scale: int = 2,
        attn_layer_type: str = "GptBlock_Attn",
        num_pages: Optional[int] = None,
        page_size: Optional[int] = None,
        kv_dtype: Optional[str] = None,
    ):
        if slots < 1 or max_len < 1:
            raise ValueError(
                f"need positive slots/max_len, got {slots}/{max_len}"
            )
        if (num_pages is None) != (page_size is None):
            raise ValueError(
                "pass num_pages AND page_size together (the paged "
                "operating point) or neither (slot layout)"
            )
        if num_pages is not None and (num_pages < 1 or page_size < 1):
            raise ValueError(
                f"need positive num_pages/page_size, got "
                f"{num_pages}/{page_size}"
            )
        if kv_dtype is not None and num_pages is None:
            raise ValueError(
                "kv_dtype is a paged-pool policy; pass num_pages/"
                "page_size with it"
            )
        self._model_config = model_config
        self._slots = int(slots)
        self._max_len = int(max_len)
        self._num_pages = None if num_pages is None else int(num_pages)
        self._page_size = None if page_size is None else int(page_size)
        self._kv_dtype = None if kv_dtype is None else str(kv_dtype)
        self._param_scale = int(param_scale)
        self._attn_layer_type = attn_layer_type
        self._result: Optional[Tuple[List[float], List[float]]] = None

    @property
    def model_config(self) -> List[Dict]:
        return self._model_config

    @property
    def operating_point(self) -> Dict[str, int]:
        """The (slots, max_len) the profile was taken at, plus
        (num_pages, page_size) and a set ``kv_dtype`` on the paged path:
        a partition is never reused at another serving configuration
        without solving again."""
        point = dict(slots=self._slots, max_len=self._max_len)
        if self._num_pages is not None:
            point.update(num_pages=self._num_pages,
                         page_size=self._page_size)
            if self._kv_dtype is not None:
                point.update(kv_dtype=self._kv_dtype)
        return point

    def benchmark(self) -> Tuple[List[float], List[float]]:
        if self._result is None:
            self._result = self._benchmark()
        return self._result

    def _benchmark(self) -> Tuple[List[float], List[float]]:
        S = self._slots
        if self._num_pages is not None:
            kv_mb = paged_kv_mb_per_layer(
                self._model_config, self._num_pages, self._page_size,
                attn_layer_type=self._attn_layer_type,
                kv_dtype=self._kv_dtype,
            )
        else:
            kv_mb = kv_mb_per_layer(
                self._model_config, S, self._max_len,
                attn_layer_type=self._attn_layer_type,
            )
        index = torch.empty((S,), dtype=torch.int32, device="meta")
        # the decode wavefront: token ids enter the first unit, the
        # hidden state threads through the rest, as in an engine tick
        current: Tuple[torch.Tensor, ...] = (
            torch.empty((S, 1), dtype=torch.int32, device="meta"),)
        cost_list: List[float] = []
        mem_list: List[float] = []
        cache: Dict[str, Tuple] = {}
        for i, layer_cfg in enumerate(self._model_config):
            key = _layer_key(layer_cfg, current)
            if key not in cache:
                cache_avals = None
                if layer_cfg["layer_type"] == self._attn_layer_type:
                    spec = kv_spec_from_config(layer_cfg.get("config", {}),
                                               self._max_len)
                    slab = torch.empty(spec.slab_shape(S),
                                       dtype=torch_dtype(spec.dtype),
                                       device="meta")
                    cache_avals = (slab, slab)
                out, flops, mem = Estimator.benchmark_decode_step(
                    _build_unit(layer_cfg, "meta"), current,
                    cache_avals=cache_avals, index=index,
                    param_scale=self._param_scale,
                )
                data_out = out[0] if cache_avals is not None else out
                cache[key] = (_tensors(data_out), flops, mem)
            current, flops, mem = cache[key]
            cost_list.append(flops)
            mem_list.append(mem + kv_mb[i])
        return cost_list, mem_list


__all__ = ["DecodeModelBenchmarker"]
