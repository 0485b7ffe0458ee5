"""Paged KV-cache bookkeeping: page allocator, radix prefix cache, swap.

PURE STDLIB BY CONTRACT (the skylint/router idiom): everything here is
host-side decision logic over ints and tuples — no jax, no numpy — so
``tools/paging_smoke.py`` can load this file by path on a bare CI
runner and exercise every allocator/refcount/radix decision without an
accelerator stack installed.  The device half (slab gather/scatter
math) lives in ``serving/kv_cache.py`` next to the slot-slab helpers.

Why pages.  The slot layout strands memory: one request = one fixed
``[max_len]`` cache row, so a 14-token prompt in a 192-position row
wastes ~93% of it and concurrency is hard-capped at the slot count.
PagedAttention (Kwon et al., SOSP '23) recovers that memory by slicing
the slab into fixed ``page_size``-position **pages** handed out from a
free list; a request holds ``ceil(len / page_size)`` pages instead of a
whole row, so concurrency floats with actual footprint at equal pool
MB.  SGLang-style **radix prefix caching** then makes shared prompt
prefixes compute-once: finished prompts stay indexed by token ids, a
new request that shares a prefix maps the matching pages (refcount
bump) and only prefills its tail.

The invariants, in one place:

- **refcounts own liveness**: a page is free iff its refcount is zero.
  Live request tables hold one ref per mapped page; the radix index
  holds one ref per page of every cached prefix.  Releasing a request
  can therefore leave its prompt pages alive (cache retention — the
  whole point), and evicting a cache entry can leave pages alive that
  a running request still maps.
- **only whole tokens are shared, only read-only pages are mapped**: a
  full page inside the shared prefix is mapped directly; the partial
  tail page of a prefix is **copied on write** (the engine performs the
  device copy the :class:`PageGrant` names) into a private page before
  the sharer appends — nobody ever writes a page another holder can
  read, so sharing is safe without any versioning.
- **admission charges pages**: :meth:`PagedKVCachePool.acquire`
  reserves the request's full worst-case footprint
  (``ceil((len + max_new) / page_size)`` minus the fully-shared pages)
  up front, evicting least-recently-used cache entries when the free
  list runs short.  A request that cannot be charged queues (``None``),
  never corrupts — the slot pool's exhaustion-is-queueing contract at
  page granularity, and full reservation means a running request can
  never die of page exhaustion mid-decode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` positions (ceil division)."""
    return -(-int(length) // int(page_size))


#: bytes per stored KV element, by pool dtype — pure stdlib on purpose
#: (no jnp.dtype here): this table is the ONE place the quantized byte
#: width is defined, shared by the allocator accounting below, the
#: engine's slab allocation (serving/kv_cache.py calls back into
#: :func:`paged_pool_mb`), and the pre-flight verifier
#: (analysis/plan_check.py) — so "the allocator accepted it" and "the
#: verifier accepted it" can never disagree on pool size.
KV_DTYPE_ITEMSIZE: Dict[str, int] = {
    "int8": 1,
    "float16": 2,
    "bfloat16": 2,
    "float32": 4,
    "float64": 8,
}

#: the scale slab's element width (float32 per (page, head) — one scale
#: per quantized tile, see serving/kv_cache.QuantizedPages)
KV_SCALE_ITEMSIZE = 4


def paged_pool_mb(
    num_pages: int,
    page_size: int,
    num_heads: int,
    head_dim: int,
    kv_dtype: str = "float32",
) -> float:
    """MB of one attention layer's paged (k, v) pool PAIR.

    ``kv_dtype="int8"`` charges 1-byte values plus the parallel
    per-page-per-head float32 scale slabs (k and v each carry one) —
    the scale overhead is ``4 / (page_size * head_dim)`` bytes per
    position per head, so int8 still lands ~4x the pages per MB of a
    float32 pool and ~2x a bf16 one (the ``pages_per_mb`` doubling the
    bench gates).  Unknown dtypes raise: silent fallback here would let
    the allocator and verifier drift apart.
    """
    try:
        itemsize = KV_DTYPE_ITEMSIZE[str(kv_dtype)]
    except KeyError:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; known: "
            f"{sorted(KV_DTYPE_ITEMSIZE)}"
        ) from None
    n = float(num_pages) * page_size * num_heads * head_dim
    values = 2.0 * n * itemsize  # the (k, v) pair
    scales = (
        2.0 * float(num_pages) * num_heads * KV_SCALE_ITEMSIZE
        if str(kv_dtype) == "int8" else 0.0
    )
    return (values + scales) / 1024.0 ** 2


def pages_per_mb(
    page_size: int, num_heads: int, head_dim: int,
    kv_dtype: str = "float32",
) -> float:
    """Pages one MB of pool holds at this dtype — the capacity knob the
    int8 policy turns (scale-slab overhead included)."""
    per_page = paged_pool_mb(1, page_size, num_heads, head_dim,
                             kv_dtype=kv_dtype)
    return 1.0 / per_page


# --------------------------------------------------------------------------
# radix prefix index
# --------------------------------------------------------------------------


class _TrieNode:
    __slots__ = ("children", "entry")

    def __init__(self):
        self.children: Dict[int, _TrieNode] = {}
        # one entry whose token sequence passes through this node (most
        # recently inserted wins) — enough to answer "who holds pages
        # covering this prefix", because any sequence through the node
        # shares the node's full root path
        self.entry: Optional["_PrefixEntry"] = None


@dataclass
class _PrefixEntry:
    tokens: Tuple[int, ...]
    pages: Tuple[int, ...]
    stamp: int  # logical LRU clock, bumped on every hit


class RadixPrefixIndex:
    """Token-id trie mapping cached prompt prefixes to their pages.

    ``insert(tokens, pages)`` records a served prompt; ``lookup(query)``
    returns ``(shared, pages)`` where ``shared`` is the longest common
    prefix (in tokens) between the query and any cached prompt, and
    ``pages`` is the cached prompt's page list (its first
    ``ceil(shared / page_size)`` entries cover the match).  Entries are
    bounded (``max_entries``) and evicted least-recently-used; eviction
    returns the evicted entry so the pool can drop its page refs.

    The trie is rebuilt from the surviving entries on eviction — entry
    counts are bounded and prompts are short relative to rebuild cost,
    and a rebuild can never leave a stale ``node.entry`` pointing at
    freed pages (the failure mode incremental unlinking invites).
    """

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}"
            )
        self.max_entries = int(max_entries)
        self._entries: Dict[Tuple[int, ...], _PrefixEntry] = {}
        self._root = _TrieNode()
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> bool:
        """Record ``tokens -> pages``.  Returns True when a NEW entry
        was created (the caller then owns bumping page refcounts); an
        existing identical prompt only refreshes its LRU stamp — its
        original pages stay authoritative, so no refs change hands."""
        key = tuple(int(t) for t in tokens)
        if not key:
            return False
        existing = self._entries.get(key)
        if existing is not None:
            existing.stamp = self._tick()
            return False
        entry = _PrefixEntry(key, tuple(int(p) for p in pages),
                             self._tick())
        self._entries[key] = entry
        node = self._root
        node.entry = entry
        for t in key:
            node = node.children.setdefault(t, _TrieNode())
            node.entry = entry
        return True

    def lookup(self, tokens: Sequence[int]) -> Tuple[int, Tuple[int, ...]]:
        """Longest cached prefix of ``tokens``: ``(shared, pages)``;
        ``(0, ())`` on a miss.  Refreshes the donor's LRU stamp — a
        prefix that keeps getting hit is the last one to evict."""
        depth, entry = self.lookup_entry(tokens)
        if entry is None:
            return 0, ()
        return depth, entry.pages

    def lookup_entry(
        self, tokens: Sequence[int],
    ) -> Tuple[int, Optional[_PrefixEntry]]:
        """Like :meth:`lookup` but returns the donor entry itself (the
        pool needs its token key to shield it from LRU eviction while a
        grant against it is in flight)."""
        node = self._root
        depth = 0
        best: Optional[_PrefixEntry] = None
        for t in tokens:
            child = node.children.get(int(t))
            if child is None:
                break
            node = child
            depth += 1
            if node.entry is not None:
                best = node.entry
        if best is None or depth == 0:
            return 0, None
        best.stamp = self._tick()
        return depth, best

    def evict_lru(
        self, protect: Tuple[int, ...] = (),
    ) -> Optional[_PrefixEntry]:
        """Evict the least-recently-used entry (skipping the ``protect``
        token sequence — the donor of an in-flight grant must survive
        the eviction its own admission triggers).  Returns the evicted
        entry so the caller drops its page refs, or None."""
        victims = [
            e for k, e in self._entries.items() if k != tuple(protect)
        ]
        if not victims:
            return None
        victim = min(victims, key=lambda e: e.stamp)
        del self._entries[victim.tokens]
        self._rebuild()
        return victim

    def clear(self) -> List[_PrefixEntry]:
        """Drop every entry (page-geometry reconfigure); returns them
        so the caller releases their refs."""
        dropped = list(self._entries.values())
        self._entries.clear()
        self._root = _TrieNode()
        return dropped

    def _rebuild(self) -> None:
        self._root = _TrieNode()
        for entry in self._entries.values():
            node = self._root
            node.entry = entry
            for t in entry.tokens:
                node = node.children.setdefault(t, _TrieNode())
                node.entry = entry


# --------------------------------------------------------------------------
# page pool
# --------------------------------------------------------------------------


@dataclass
class PageGrant:
    """One admission's page reservation, returned by
    :meth:`PagedKVCachePool.acquire`.

    ``page_table`` maps logical page k -> physical page id for the
    request's whole reserved span.  ``shared_tokens`` of the prefix are
    already resident (prefill only the tail from there).  When the
    shared prefix ends mid-page, ``cow_src``/``cow_dst`` name the
    device copy the engine must perform BEFORE writing: the donor's
    partial page is cloned into the request's first private page so
    the append never touches a shared page."""

    request_id: int
    page_table: List[int]
    shared_tokens: int = 0
    shared_pages: int = 0
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None
    new_pages: List[int] = field(default_factory=list)


class PagedKVCachePool:
    """Free-list page allocator + refcounts + radix prefix cache.

    Host bookkeeping only — one instance per engine governs the page id
    space across every pipeline stage (page id p addresses row p of all
    stages' slabs, the paged twin of the slot pool's cross-stage slot
    ids).  Exhaustion contract: :meth:`acquire` returns ``None`` when
    the request cannot be charged even after evicting reusable cache
    entries — a queueing condition for the admission layer, never an
    error, and never a partial mutation.
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        max_pages_per_request: int,
        *,
        enable_prefix_cache: bool = True,
        max_prefix_entries: int = 256,
        kv_dtype: str = "float32",
    ):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need positive num_pages/page_size, got "
                f"{num_pages}/{page_size}"
            )
        if not 1 <= max_pages_per_request <= num_pages:
            raise ValueError(
                f"max_pages_per_request must be in [1, {num_pages}], "
                f"got {max_pages_per_request}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_request = int(max_pages_per_request)
        # the allocator POLICY knob: what a page physically stores.
        # "int8" pages carry a parallel per-page-per-head scale slab —
        # the accounting here (pool_mb) and every page copy the pool
        # plans (cow_plan, the engine's swap path) must include it.
        # Any other string is carried verbatim as the MODEL dtype (the
        # engine passes it through for accounting/labels; only
        # pool_mb's byte table is strict, and only when asked).
        self.kv_dtype = str(kv_dtype)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        # LIFO free list, same warm-row rationale as the slot pool
        self._free: List[int] = list(range(self.num_pages))[::-1]
        self._refs: Dict[int, int] = {}
        self._tables: Dict[int, List[int]] = {}  # request_id -> pages
        self.index = RadixPrefixIndex(max_prefix_entries)
        # counters (the engine mirrors these into ServingStats)
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefix_evictions = 0
        self.cow_copies = 0

    # --- accounting ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def reclaimable_pages(self) -> int:
        """Free pages obtainable by evicting every cache entry: cached
        pages whose ONLY refs are cache refs.  Admission headroom is
        ``free_pages + reclaimable_pages``."""
        claims: Dict[int, int] = {}
        for entry in self.index._entries.values():
            for p in entry.pages:
                claims[p] = claims.get(p, 0) + 1
        return sum(
            1 for p, n in claims.items() if self._refs.get(p, 0) == n
        )

    @property
    def virtual_len(self) -> int:
        """Positions one request can span: the paged ``max_len``."""
        return self.max_pages_per_request * self.page_size

    def pool_mb(self, num_heads: int, head_dim: int) -> float:
        """One attention layer's (k, v) pool MB at this pool's
        ``kv_dtype`` — scale slabs included under int8 (the single
        quantized-width formula, see :func:`paged_pool_mb`)."""
        return paged_pool_mb(
            self.num_pages, self.page_size, num_heads, head_dim,
            kv_dtype=self.kv_dtype,
        )

    def cow_plan(self, grant: "PageGrant") -> List[Tuple[str, int, int]]:
        """Device copies a grant's copy-on-write clone requires:
        ``[("values", src, dst)]`` — plus ``("scales", src, dst)`` on an
        int8 pool, because a cloned page dequantized with the DONOR's
        scale but re-scaled under its new owner would silently corrupt
        the shared prefix.  The engine executes this plan across every
        stage's slabs; an empty list means no COW was granted."""
        if grant.cow_src is None:
            return []
        plan: List[Tuple[str, int, int]] = [
            ("values", grant.cow_src, grant.cow_dst)
        ]
        if self.kv_dtype == "int8":
            plan.append(("scales", grant.cow_src, grant.cow_dst))
        return plan

    def table(self, request_id: int) -> List[int]:
        return list(self._tables[request_id])

    def holds(self, request_id: int) -> bool:
        return request_id in self._tables

    # --- ref plumbing -------------------------------------------------------
    def _ref(self, page: int) -> None:
        self._refs[page] = self._refs.get(page, 0) + 1

    def _unref(self, page: int) -> bool:
        """Drop one ref; True when the page fell free."""
        n = self._refs.get(page, 0) - 1
        if n < 0:
            raise ValueError(f"page {page} unref'd below zero")
        if n == 0:
            del self._refs[page]
            self._free.append(page)
            return True
        self._refs[page] = n
        return False

    def _can_cover(self, need: int,
                   protect: Tuple[int, ...] = ()) -> bool:
        """Whether ``need`` pages are coverable by the free list plus
        full eviction of every unprotected cache entry — checked BEFORE
        evicting, so a doomed acquire returns None without spending the
        cache."""
        if len(self._free) >= need:
            return True
        claims: Dict[int, int] = {}
        for key, entry in self.index._entries.items():
            if key == tuple(protect):
                continue
            for p in entry.pages:
                claims[p] = claims.get(p, 0) + 1
        reclaimable = sum(
            1 for p, n in claims.items() if self._refs.get(p, 0) == n
        )
        return len(self._free) + reclaimable >= need

    def _evict_until(self, need: int,
                     protect: Tuple[int, ...] = ()) -> None:
        """Evict LRU cache entries until ``need`` pages are free (or no
        evictable entry remains).  ``protect`` shields the donor prompt
        of the in-flight acquire."""
        while len(self._free) < need:
            victim = self.index.evict_lru(protect)
            if victim is None:
                return
            self.prefix_evictions += 1
            for p in victim.pages:
                self._unref(p)

    # --- admission ----------------------------------------------------------
    def peek_shared(self, tokens: Sequence[int]) -> int:
        """Shared-prefix tokens a lookup WOULD reuse (no state change
        beyond an LRU refresh): capped at ``len(tokens) - 1`` so the
        last prompt position is always recomputed — its logits seed the
        first generated token."""
        if not self.enable_prefix_cache:
            return 0
        shared, _ = self.index.lookup(tokens)
        return min(shared, len(tokens) - 1)

    def acquire(
        self,
        request_id: int,
        tokens: Sequence[int],
        total_len: int,
        *,
        use_prefix: bool = True,
    ) -> Optional[PageGrant]:
        """Charge a request's full reserved span and build its table.

        ``tokens`` is the effective prompt (prefix-cache key);
        ``total_len`` the worst-case sequence length to reserve
        (``len(tokens) + max_new``).  Returns ``None`` — with NO state
        mutated — when the free list (after LRU cache eviction) cannot
        cover the non-shared pages.
        """
        if request_id in self._tables:
            raise ValueError(f"request {request_id} already holds pages")
        tokens = tuple(int(t) for t in tokens)
        total_len = max(int(total_len), len(tokens))
        total_pages = pages_for(total_len, self.page_size)
        if total_pages > self.max_pages_per_request:
            raise ValueError(
                f"request {request_id} needs {total_pages} pages; "
                f"max_pages_per_request={self.max_pages_per_request}"
            )
        shared = 0
        donor: Tuple[int, ...] = ()
        donor_tokens: Tuple[int, ...] = ()
        if use_prefix and self.enable_prefix_cache and tokens:
            matched, entry = self.index.lookup_entry(tokens)
            if entry is not None:
                donor = entry.pages
                donor_tokens = entry.tokens
            shared = min(matched, len(tokens) - 1)
        s_full = shared // self.page_size
        need = total_pages - s_full
        if not self._can_cover(need, protect=donor_tokens):
            return None  # even full cache eviction cannot cover it
        if len(self._free) < need:
            # eviction must never free the donor's pages mid-grant:
            # its exact token sequence is shielded (protection is the
            # contract, not the LRU-refresh recency luck of lookup)
            self._evict_until(need, protect=donor_tokens)
        if len(self._free) < need:
            return None
        new = [self._free.pop() for _ in range(need)]
        table = list(donor[:s_full]) + new
        for p in donor[:s_full]:
            self._ref(p)
        for p in new:
            self._refs[p] = 1
        cow_src = cow_dst = None
        if shared % self.page_size:
            # the prefix ends mid-page: clone the donor's partial page
            # into the first private page before any append touches it
            cow_src = donor[s_full]
            cow_dst = new[0]
            self.cow_copies += 1
        if shared:
            self.prefix_hits += 1
            self.prefix_tokens_reused += shared
        self._tables[request_id] = table
        return PageGrant(
            request_id=request_id,
            page_table=list(table),
            shared_tokens=shared,
            shared_pages=s_full,
            cow_src=cow_src,
            cow_dst=cow_dst,
            new_pages=new,
        )

    def acquire_pages(self, request_id: int,
                      n_pages: int) -> Optional[List[int]]:
        """Plain page reservation with no prefix semantics (the swap-in
        resume path: contents arrive from the host pool, not prefill)."""
        if request_id in self._tables:
            raise ValueError(f"request {request_id} already holds pages")
        n_pages = int(n_pages)
        if not 1 <= n_pages <= self.max_pages_per_request:
            raise ValueError(
                f"need 1..{self.max_pages_per_request} pages, "
                f"got {n_pages}"
            )
        if not self._can_cover(n_pages):
            return None
        if len(self._free) < n_pages:
            self._evict_until(n_pages)
        if len(self._free) < n_pages:
            return None
        pages = [self._free.pop() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = 1
        self._tables[request_id] = pages
        return list(pages)

    def rollback_grant(self, grant: PageGrant) -> None:
        """Undo an acquire whose wave the engine then refused (tail
        bucket disagreed after eviction): pages handed back AND the
        hit/COW counters reversed, so observability never counts reuse
        that did not happen.  Only valid before any device work used
        the grant."""
        self.release(grant.request_id)
        if grant.shared_tokens:
            self.prefix_hits -= 1
            self.prefix_tokens_reused -= grant.shared_tokens
        if grant.cow_src is not None:
            self.cow_copies -= 1

    def release(self, request_id: int) -> int:
        """Drop the request's refs; returns how many pages fell free.
        Pages the radix cache (or another request) still references
        survive — that is the cache-retention win, not a leak."""
        table = self._tables.pop(request_id, None)
        if table is None:
            raise KeyError(f"request {request_id} holds no pages")
        return sum(1 for p in table if self._unref(p))

    def register_prefix(self, request_id: int,
                        tokens: Sequence[int]) -> bool:
        """Index a served prompt so later requests can share it.  The
        entry refs the prompt-covering prefix of the request's table,
        keeping those pages warm after the request finishes."""
        if not self.enable_prefix_cache:
            return False
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            return False
        table = self._tables.get(request_id)
        if table is None:
            raise KeyError(f"request {request_id} holds no pages")
        n = pages_for(len(tokens), self.page_size)
        pages = table[:n]
        if (tuple(tokens) not in self.index._entries
                and len(self.index) >= self.index.max_entries):
            victim = self.index.evict_lru()
            if victim is not None:
                self.prefix_evictions += 1
                for p in victim.pages:
                    self._unref(p)
        if not self.index.insert(tokens, pages):
            return False
        for p in pages:
            self._ref(p)
        return True

    def drop_prefix_cache(self) -> int:
        """Evict every cache entry (reconfigure path); returns pages
        freed."""
        freed = 0
        for entry in self.index.clear():
            self.prefix_evictions += 1
            freed += sum(1 for p in entry.pages if self._unref(p))
        return freed

    def check_consistency(self) -> None:
        """Invariant audit for tests: every refcount equals the number
        of table + cache claims, and the free list is exactly the
        unreferenced pages."""
        claims: Dict[int, int] = {}
        for table in self._tables.values():
            for p in table:
                claims[p] = claims.get(p, 0) + 1
        for entry in self.index._entries.values():
            for p in entry.pages:
                claims[p] = claims.get(p, 0) + 1
        if claims != self._refs:
            raise AssertionError(
                f"refcount drift: claims={claims} refs={self._refs}"
            )
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates")
        if free & set(self._refs):
            raise AssertionError("page both free and referenced")
        if free | set(self._refs) != set(range(self.num_pages)):
            raise AssertionError("page neither free nor referenced")


# --------------------------------------------------------------------------
# decode-row ledger
# --------------------------------------------------------------------------


class RowAllocator:
    """Free-list ledger for decode rows (concurrency lanes).

    The paged decode program is still a fixed shape — ``[rows, 1]``
    tokens against ``[rows, max_pages]`` page tables — so a running
    request occupies a *row*, which is pure bookkeeping (its KV lives
    in pages).  Mirrors the slot pool's host interface
    (``allocate``/``acquire``/``release``/``free_slots``/...) so fleet
    replicas' slot-accounting and chaos fault surface work unchanged on
    paged engines; ``total_mb`` is 0 — rows own no device memory.
    """

    def __init__(self, rows: int):
        if rows < 1:
            raise ValueError(f"need at least 1 row, got {rows}")
        self.num_slots = int(rows)
        self._free: List[int] = list(range(self.num_slots))[::-1]

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_slots / self.num_slots

    def allocate(self) -> Optional[int]:
        if not self._free:
            return None
        return self._free.pop()

    def acquire(self, row: int) -> None:
        if row not in self._free:
            raise ValueError(f"row {row} is not free")
        self._free.remove(row)

    def release(self, row: int) -> None:
        if not 0 <= row < self.num_slots:
            raise ValueError(
                f"row {row} out of range [0, {self.num_slots})"
            )
        if row in self._free:
            raise ValueError(f"row {row} double-released")
        self._free.append(row)

    def total_mb(self) -> float:
        return 0.0


# --------------------------------------------------------------------------
# chunked-prefill budget policy
# --------------------------------------------------------------------------


class ChunkBudgetPolicy:
    """Per-tick prefill-chunk admission budget (pure scheduling).

    Chunked prefill splits a prompt's non-shared tail into fixed
    ``prefill_chunk``-token chunks that ride engine ticks alongside the
    decode slab, so decode ticks are never stalled behind a whole
    prompt's prefill.  This policy is the knob that bounds the
    interleave: each tick it grants at most ``max_chunk_rows`` chunk
    rows while any request is decoding, so **no decode tick ever waits
    behind more than ``max_chunk_rows x prefill_chunk`` prefill
    positions** — the starvation bound
    (:meth:`starvation_bound_tokens`).  When nothing is decoding there
    is nothing to starve, and the budget opens up to
    ``idle_chunk_rows`` so a cold engine's prefill does not crawl.

    Pure stdlib by contract (this module's standing rule):
    ``tools/chunk_smoke.py`` file-path-loads it in the CI lint job and
    drives the decision table on a bare runner.
    """

    def __init__(
        self,
        prefill_chunk: int,
        max_chunk_rows: int = 1,
        idle_chunk_rows: Optional[int] = None,
    ):
        if int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if int(max_chunk_rows) < 1:
            raise ValueError(
                f"max_chunk_rows must be >= 1, got {max_chunk_rows}"
            )
        self.prefill_chunk = int(prefill_chunk)
        self.max_chunk_rows = int(max_chunk_rows)
        self.idle_chunk_rows = (
            int(idle_chunk_rows) if idle_chunk_rows is not None
            else max(self.max_chunk_rows, 4)
        )
        if self.idle_chunk_rows < self.max_chunk_rows:
            raise ValueError(
                f"idle_chunk_rows {self.idle_chunk_rows} must be >= "
                f"max_chunk_rows {self.max_chunk_rows} (an idle engine "
                f"never has less headroom than a busy one)"
            )

    def rows_for_tick(self, *, pending: int, decoding: int) -> int:
        """Chunk rows this tick may prefill.

        ``pending`` = requests holding pages mid-prefill; ``decoding``
        = requests in the running decode batch.  Returns 0 when there
        is nothing to chunk; otherwise the decode-protecting bound (or
        the idle bound when no decode work exists to protect).
        """
        if pending <= 0:
            return 0
        if decoding <= 0:
            return min(pending, self.idle_chunk_rows)
        return min(pending, self.max_chunk_rows)

    def starvation_bound_tokens(self) -> int:
        """Worst-case prefill positions any decode tick can wait
        behind: the chunk interleave's latency guarantee."""
        return self.max_chunk_rows * self.prefill_chunk


# --------------------------------------------------------------------------
# preemption mode policy
# --------------------------------------------------------------------------


def preempt_costs(
    resume_tokens: int,
    page_count: int,
    page_size: int,
    *,
    recompute_token_cost: float = 1.0,
    swap_position_cost: float = 0.25,
) -> Tuple[float, float]:
    """(recompute_cost, swap_cost) of resuming a preempted request.

    Recompute replays ``resume_tokens`` of prefill compute; swap moves
    ``page_count * page_size`` cache positions across the host link
    twice (out + in).  The unit costs are relative weights — on real
    hardware they calibrate to measured prefill tok/s vs host-link
    GB/s; the CPU-fallback default makes swap win once a sequence has
    meaningfully outgrown a page, matching the intuition that long
    sequences are exactly the ones recomputation punishes."""
    recompute = float(resume_tokens) * float(recompute_token_cost)
    swap = 2.0 * page_count * page_size * float(swap_position_cost)
    return recompute, swap


def choose_preempt_mode(
    resume_tokens: int,
    page_count: int,
    page_size: int,
    *,
    recompute_token_cost: float = 1.0,
    swap_position_cost: float = 0.25,
    recompute_feasible: bool = True,
) -> str:
    """``"swap"`` or ``"recompute"`` — cheapest resume wins; a resume
    prefix that no longer fits any prefill bucket forces swap (the case
    recomputation structurally cannot serve)."""
    if not recompute_feasible:
        return "swap"
    recompute, swap = preempt_costs(
        resume_tokens, page_count, page_size,
        recompute_token_cost=recompute_token_cost,
        swap_position_cost=swap_position_cost,
    )
    return "swap" if swap < recompute else "recompute"


__all__ = [
    "ChunkBudgetPolicy",
    "KV_DTYPE_ITEMSIZE",
    "PageGrant",
    "PagedKVCachePool",
    "RadixPrefixIndex",
    "RowAllocator",
    "choose_preempt_mode",
    "paged_pool_mb",
    "pages_for",
    "pages_per_mb",
    "preempt_costs",
]
