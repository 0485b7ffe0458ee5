"""Continuous-batching GPT serving over slot slabs or a paged KV pool
(the port of ``skycomputing_tpu/serving``, both layouts, on one stage
or on several placed by an allocator):

- :mod:`.kv_cache` — slot slabs (:func:`init_layer_caches`,
  :class:`SlotKVCachePool`, the in-place slot write), paged slab math
  for fp and int8 pools (write plans, in-place scatter and
  quantize-on-write, gather, allocation), and the KV memory formulas
  (:func:`kv_mb_per_layer`, :func:`paged_kv_mb_per_layer`);
- :mod:`.profile` — :class:`DecodeModelBenchmarker`, the decode-step
  profile ``Allocator.serving_allocate`` solves over;
- :mod:`.paging` — host bookkeeping (pure stdlib, a copy of the JAX
  package's): page allocator, refcounts, radix prefix cache, COW, chunk
  budget, preemption policy, the pool-size formulas;
- :mod:`.batcher` — requests, prompt-length buckets, admission queue;
- :mod:`.speculative` — the prefix-slice draft and greedy acceptance;
- :mod:`.engine` — :class:`ServingEngine` and :class:`ServingStats`.
"""

from .batcher import AdmissionQueue, QueueFullError, Request, ShapeBucketer
from .engine import ServingEngine, ServingStats
from .kv_cache import (
    KVCacheSpec,
    QuantizedPages,
    SlotKVCachePool,
    gather_kv_pages,
    init_layer_caches,
    init_paged_caches,
    kv_mb_per_layer,
    kv_spec_from_config,
    paged_kv_mb_per_layer,
    paged_update_kv,
    quantize_pages,
    update_kv_cache,
)
from .paging import (
    ChunkBudgetPolicy,
    KV_DTYPE_ITEMSIZE,
    PagedKVCachePool,
    RadixPrefixIndex,
    RowAllocator,
    choose_preempt_mode,
    paged_pool_mb,
    pages_for,
    pages_per_mb,
)
from .profile import DecodeModelBenchmarker
from .speculative import DraftModel, greedy_accept_count

__all__ = [
    "AdmissionQueue",
    "ChunkBudgetPolicy",
    "DecodeModelBenchmarker",
    "DraftModel",
    "KVCacheSpec",
    "KV_DTYPE_ITEMSIZE",
    "PagedKVCachePool",
    "QuantizedPages",
    "QueueFullError",
    "RadixPrefixIndex",
    "Request",
    "RowAllocator",
    "ServingEngine",
    "ServingStats",
    "ShapeBucketer",
    "SlotKVCachePool",
    "choose_preempt_mode",
    "gather_kv_pages",
    "greedy_accept_count",
    "init_layer_caches",
    "init_paged_caches",
    "kv_mb_per_layer",
    "kv_spec_from_config",
    "paged_kv_mb_per_layer",
    "paged_pool_mb",
    "paged_update_kv",
    "pages_for",
    "pages_per_mb",
    "quantize_pages",
    "update_kv_cache",
]
