"""Continuous-batching GPT serving over a paged KV pool (the port of
``skycomputing_tpu/serving``, paged layout, one stage):

- :mod:`.kv_cache` — paged slab math for fp and int8 pools (write plans,
  in-place scatter and quantize-on-write, gather, allocation);
- :mod:`.paging` — host bookkeeping (pure stdlib, a copy of the JAX
  package's): page allocator, refcounts, radix prefix cache, COW, chunk
  budget, preemption policy;
- :mod:`.batcher` — requests, prompt-length buckets, admission queue;
- :mod:`.speculative` — the prefix-slice draft and greedy acceptance;
- :mod:`.engine` — :class:`ServingEngine` and :class:`ServingStats`.
"""

from .batcher import AdmissionQueue, QueueFullError, Request, ShapeBucketer
from .engine import ServingEngine, ServingStats
from .kv_cache import (
    KVCacheSpec,
    QuantizedPages,
    gather_kv_pages,
    init_paged_caches,
    kv_spec_from_config,
    paged_update_kv,
    quantize_pages,
)
from .paging import PagedKVCachePool, RowAllocator, pages_for
from .speculative import DraftModel, greedy_accept_count

__all__ = [
    "AdmissionQueue",
    "DraftModel",
    "KVCacheSpec",
    "PagedKVCachePool",
    "QuantizedPages",
    "QueueFullError",
    "Request",
    "RowAllocator",
    "ServingEngine",
    "ServingStats",
    "ShapeBucketer",
    "gather_kv_pages",
    "greedy_accept_count",
    "init_paged_caches",
    "kv_spec_from_config",
    "pages_for",
    "paged_update_kv",
    "quantize_pages",
]
