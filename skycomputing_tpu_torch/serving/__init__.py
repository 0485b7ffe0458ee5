"""Continuous-batching GPT serving over a paged KV pool (the port of
``skycomputing_tpu/serving``, paged layout, one stage):

- :mod:`.kv_cache` — paged slab math (write plan, in-place scatter,
  gather, allocation);
- :mod:`.paging` — host bookkeeping (pure stdlib, a copy of the JAX
  package's): page allocator, refcounts, radix prefix cache, COW;
- :mod:`.batcher` — requests, prompt-length buckets, admission queue;
- :mod:`.engine` — :class:`ServingEngine` and :class:`ServingStats`.
"""

from .batcher import AdmissionQueue, QueueFullError, Request, ShapeBucketer
from .engine import ServingEngine, ServingStats
from .kv_cache import (
    KVCacheSpec,
    gather_kv_pages,
    init_paged_caches,
    kv_spec_from_config,
    paged_update_kv,
)
from .paging import PagedKVCachePool, RowAllocator, pages_for

__all__ = [
    "AdmissionQueue",
    "KVCacheSpec",
    "PagedKVCachePool",
    "QueueFullError",
    "Request",
    "RowAllocator",
    "ServingEngine",
    "ServingStats",
    "ShapeBucketer",
    "gather_kv_pages",
    "init_paged_caches",
    "kv_spec_from_config",
    "pages_for",
    "paged_update_kv",
]
