"""Continuous-batching GPT serving over a paged KV pool (the port of
``skycomputing_tpu/serving``, paged layout, on one stage or on several
placed by an allocator):

- :mod:`.kv_cache` — paged slab math for fp and int8 pools (write plans,
  in-place scatter and quantize-on-write, gather, allocation), the slot
  write the decode profile counts, and the KV memory formulas
  (:func:`kv_mb_per_layer`, :func:`paged_kv_mb_per_layer`);
- :mod:`.profile` — :class:`DecodeModelBenchmarker`, the decode-step
  profile ``Allocator.serving_allocate`` solves over;
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
    kv_mb_per_layer,
    kv_spec_from_config,
    paged_kv_mb_per_layer,
    paged_update_kv,
    quantize_pages,
)
from .paging import PagedKVCachePool, RowAllocator, pages_for
from .profile import DecodeModelBenchmarker
from .speculative import DraftModel, greedy_accept_count

__all__ = [
    "AdmissionQueue",
    "DecodeModelBenchmarker",
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
    "kv_mb_per_layer",
    "kv_spec_from_config",
    "pages_for",
    "paged_kv_mb_per_layer",
    "paged_update_kv",
    "quantize_pages",
]
