"""The KV-handoff contract: portable prefill→decode records + ledger.

Disaggregated serving (DistServe/Splitwise, PAPERS.md) splits one
request across two engines: a prefill specialist computes the KV pages,
a decode specialist consumes them.  The thing that crosses the gap is a
:class:`HandoffRecord` — request identity, the prefilled watermark, the
page-table index, and the sha256 checksum fold the engine's swap plane
already computes over every host slab (``_swap_record_checksum``), plus
one per-stage slab digest so a corrupted stage is attributable.  The
record deliberately carries NO tensor data: the page payload rides the
engine's own swap record (host tensors), and this module stays pure
stdlib: it loads by file path with neither torch nor numpy installed
(``tests/test_torch_disagg.py`` loads it so).

:class:`HandoffLedger` is the front door's conservation ledger.  Its
invariant — **every enqueued record sits in exactly one of
{pending, delivered, failed-with-reason}** — is what the chaos auditor
gates (``chaos/invariants.py``): a prefill replica may die mid-handoff,
a record may arrive corrupted, the decode pool may be full for a while,
but no request is ever stranded or double-consumed.  State moves are
strict (``pending → delivered``, ``pending|delivered → failed``), every
failure needs a reason, and the event log is wall-clock free so two
same-seed runs produce byte-identical ledgers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ledger states — the three (and only three) places a record can be
PENDING = "PENDING"
DELIVERED = "DELIVERED"
FAILED = "FAILED"
HANDOFF_STATES = (PENDING, DELIVERED, FAILED)


def _is_hex_digest(value: Any) -> bool:
    """A sha256 hex digest: 64 lowercase hex chars."""
    return (
        isinstance(value, str)
        and len(value) == 64
        and all(c in "0123456789abcdef" for c in value)
    )


def _pos_int(value: Any) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) \
        and value >= 1


def _non_neg_int(value: Any) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) \
        and value >= 0


@dataclass(frozen=True)
class HandoffRecord:
    """One request's portable KV identity, prefill side → decode side.

    The geometry fields (``page_size`` / ``max_pages_per_request`` /
    ``stages`` / ``kv_dtype``) are the exporting engine's — the
    importing side refuses a record whose geometry does not match its
    own (``plan_check.verify_handoff_payload``), because a swap record
    gathered under one page shape cannot seat under another.  The pool
    COUNT may differ between pools: sentinel page tables are rebuilt
    locally at swap-in, so only the per-request shape must agree.
    """

    request_id: int
    #: exporting (prefill) replica name — dead-source re-dispatch keys
    #: off this
    source: str
    prompt_len: int
    #: the prefill watermark: prompt tokens plus every token the
    #: prefill side already committed (the decode side resumes HERE)
    prefilled_len: int
    #: page-table write index the decode side resumes at
    index: int
    pages: int
    #: the engine's ``_swap_record_checksum`` fold over the whole record
    checksum: str
    #: one sha256 per stage's host slabs — a mismatch names the stage
    slab_checksums: Tuple[str, ...]
    page_size: int
    max_pages_per_request: int
    stages: int
    kv_dtype: str
    #: fleet tick the export happened on (deterministic, not wall time)
    tick: int = 0

    def __post_init__(self):
        if not _non_neg_int(self.request_id):
            raise ValueError(
                f"request_id must be a non-negative int, got "
                f"{self.request_id!r}"
            )
        if not isinstance(self.source, str) or not self.source:
            raise ValueError("source must be a non-empty replica name")
        for name in ("prompt_len", "prefilled_len", "index", "pages",
                     "page_size", "max_pages_per_request", "stages"):
            if not _pos_int(getattr(self, name)):
                raise ValueError(
                    f"{name} must be a positive int, got "
                    f"{getattr(self, name)!r}"
                )
        if self.prefilled_len < self.prompt_len:
            raise ValueError(
                f"prefilled watermark {self.prefilled_len} is below the "
                f"prompt length {self.prompt_len}: the prefill side "
                f"must at least cover the prompt"
            )
        if self.pages > self.max_pages_per_request:
            raise ValueError(
                f"pages={self.pages} exceeds max_pages_per_request="
                f"{self.max_pages_per_request}"
            )
        if self.pages * self.page_size < self.index:
            raise ValueError(
                f"{self.pages} pages of {self.page_size} tokens cannot "
                f"cover page-table index {self.index}"
            )
        if not _is_hex_digest(self.checksum):
            raise ValueError(
                "checksum must be a 64-char lowercase sha256 hex digest"
            )
        if (not isinstance(self.slab_checksums, tuple)
                or len(self.slab_checksums) != self.stages
                or not all(_is_hex_digest(c)
                           for c in self.slab_checksums)):
            raise ValueError(
                f"slab_checksums must be a tuple of {self.stages} "
                f"sha256 hex digests (one per stage)"
            )
        if not isinstance(self.kv_dtype, str) or not self.kv_dtype:
            raise ValueError("kv_dtype must be a non-empty dtype name")
        if not _non_neg_int(self.tick):
            raise ValueError(
                f"tick must be a non-negative int, got {self.tick!r}"
            )

    def key(self) -> tuple:
        """Digest-stable identity (everything, no wall-clock fields)."""
        return (
            self.request_id, self.source, self.prompt_len,
            self.prefilled_len, self.index, self.pages, self.checksum,
            self.slab_checksums, self.page_size,
            self.max_pages_per_request, self.stages, self.kv_dtype,
            self.tick,
        )

    def to_dict(self) -> Dict[str, Any]:
        """The payload shape ``verify_handoff_payload`` checks."""
        return dict(
            request_id=self.request_id,
            source=self.source,
            prompt_len=self.prompt_len,
            prefilled_len=self.prefilled_len,
            index=self.index,
            pages=self.pages,
            checksum=self.checksum,
            slab_checksums=list(self.slab_checksums),
            page_size=self.page_size,
            max_pages_per_request=self.max_pages_per_request,
            stages=self.stages,
            kv_dtype=self.kv_dtype,
            tick=self.tick,
        )


@dataclass
class _Entry:
    record: HandoffRecord
    state: str = PENDING
    #: decode replica the record was delivered to (set on delivery)
    target: str = ""
    #: failure reason (set on failure; never empty for FAILED)
    reason: Optional[str] = None


class HandoffLedger:
    """Conservation ledger for in-flight prefill→decode handoffs.

    Every record :meth:`enqueue`\\ d here is tracked until it is either
    :meth:`mark_delivered` (the decode side seated the swap record) or
    :meth:`mark_failed` (with a mandatory reason — corruption that fell
    back to recompute, a source that died before export completed,
    ...).  A delivered record may still fail afterwards (the decode
    side's swap-in verifies checksums FIRST and may only then discover
    corruption), so ``delivered → failed`` is a legal move; everything
    else terminal is final.  :meth:`audit` is the conservation check
    the chaos auditor gates.
    """

    def __init__(self):
        self._entries: Dict[int, _Entry] = {}
        # monotonic totals (counter discipline: these only go up)
        self.enqueued_total = 0
        self.delivered_total = 0
        self.failed_total = 0
        #: deterministic event log (no wall-clock, no ids beyond the
        #: request's own) — same-seed runs replay this byte-identically
        self.events: List[Dict[str, Any]] = []

    # --- state moves --------------------------------------------------------
    def enqueue(self, record: HandoffRecord) -> None:
        if not isinstance(record, HandoffRecord):
            raise ValueError(
                f"ledger takes HandoffRecord, got {type(record).__name__}"
            )
        if record.request_id in self._entries:
            raise ValueError(
                f"request {record.request_id} already has a handoff "
                f"(each request hands off at most once)"
            )
        self._entries[record.request_id] = _Entry(record=record)
        self.enqueued_total += 1
        self.events.append(dict(kind="enqueue",
                                request_id=record.request_id,
                                source=record.source,
                                tick=record.tick))

    def mark_delivered(self, request_id: int, target: str = "") -> None:
        entry = self._require(request_id)
        if entry.state != PENDING:
            raise ValueError(
                f"request {request_id} is {entry.state}, only PENDING "
                f"records can be delivered"
            )
        entry.state = DELIVERED
        entry.target = str(target)
        self.delivered_total += 1
        self.events.append(dict(kind="deliver", request_id=request_id,
                                target=str(target)))

    def mark_failed(self, request_id: int, reason: str) -> None:
        if not isinstance(reason, str) or not reason:
            raise ValueError(
                "a failed handoff needs a non-empty reason (conservation "
                "means failed-WITH-reason, never silently dropped)"
            )
        entry = self._require(request_id)
        if entry.state == FAILED:
            raise ValueError(
                f"request {request_id} already failed "
                f"({entry.reason!r})"
            )
        entry.state = FAILED
        entry.reason = reason
        self.failed_total += 1
        self.events.append(dict(kind="fail", request_id=request_id,
                                reason=reason))

    def _require(self, request_id: int) -> _Entry:
        entry = self._entries.get(request_id)
        if entry is None:
            raise ValueError(
                f"request {request_id} was never enqueued"
            )
        return entry

    # --- queries ------------------------------------------------------------
    def state_of(self, request_id: int) -> Optional[str]:
        entry = self._entries.get(request_id)
        return None if entry is None else entry.state

    def record(self, request_id: int) -> HandoffRecord:
        return self._require(request_id).record

    def reason(self, request_id: int) -> Optional[str]:
        return self._require(request_id).reason

    def pending(self) -> List[HandoffRecord]:
        """PENDING records in enqueue order (dict order is insertion)."""
        return [e.record for e in self._entries.values()
                if e.state == PENDING]

    def pending_for(self, source: str) -> List[HandoffRecord]:
        """PENDING records exported by ``source`` — what a dead prefill
        replica leaves in flight; re-dispatch works off this list."""
        return [r for r in self.pending() if r.source == source]

    def counts(self) -> Dict[str, int]:
        out = {PENDING: 0, DELIVERED: 0, FAILED: 0}
        for entry in self._entries.values():
            out[entry.state] += 1
        return out

    # --- conservation -------------------------------------------------------
    def conservation_ok(self) -> bool:
        """Every enqueued record in exactly one state, every failure
        reasoned, totals consistent with the entry map."""
        counts = self.counts()
        if sum(counts.values()) != len(self._entries):
            return False  # pragma: no cover - states are an enum
        if len(self._entries) != self.enqueued_total:
            return False
        if self.failed_total != counts[FAILED]:
            return False
        # delivered_total counts deliveries (a delivered record that
        # later failed still WAS delivered), so it bounds from above
        if counts[DELIVERED] > self.delivered_total:
            return False
        return all(
            entry.reason
            for entry in self._entries.values()
            if entry.state == FAILED
        )

    def audit(self) -> Dict[str, Any]:
        """Artifact-ready conservation summary (what the chaos
        auditor's ledger check serializes)."""
        counts = self.counts()
        reasons: Dict[str, int] = {}
        for entry in self._entries.values():
            if entry.state == FAILED and entry.reason:
                reasons[entry.reason] = reasons.get(entry.reason, 0) + 1
        return dict(
            total=len(self._entries),
            pending=counts[PENDING],
            delivered=counts[DELIVERED],
            failed=counts[FAILED],
            failed_reasons=reasons,
            enqueued_total=self.enqueued_total,
            delivered_total=self.delivered_total,
            failed_total=self.failed_total,
            conservation_ok=self.conservation_ok(),
        )

    def snapshot(self) -> Dict[str, Any]:
        """Metrics-plane view: monotonic totals + the pending gauge."""
        counts = self.counts()
        return dict(
            handoffs_enqueued=self.enqueued_total,
            handoffs_delivered=self.delivered_total,
            handoffs_failed=self.failed_total,
            handoffs_pending=counts[PENDING],
        )


__all__ = [
    "DELIVERED",
    "FAILED",
    "HANDOFF_STATES",
    "HandoffLedger",
    "HandoffRecord",
    "PENDING",
]
