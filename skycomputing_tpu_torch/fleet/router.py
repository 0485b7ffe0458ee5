"""SLO-aware request routing over engine-replica snapshots (the port's own
copy of ``skycomputing_tpu/fleet/router.py``).

PURE STDLIB BY CONTRACT (the trace_report idiom): the router is
decision logic over plain snapshot dicts — no torch, no numpy — so
``tools/bench_fleet.py --smoke`` can load it by file path on a bare CI
runner and exercise every dispatch decision on synthetic snapshots.

Policy, in priority order:

- **least-loaded**: each healthy replica's load is its outstanding work
  — queued requests plus occupied slots — scaled by its observed decode
  pace (``tpot_p95_s``) when available, so a replica that is *slower*
  per token counts as more loaded at equal depth.  This is the
  drain-time estimate, driven by the live ``MetricsRegistry`` snapshot
  (queue depth, free slots, TPOT percentiles), not a guess.
- **prefix affinity**: requests sharing a prompt prefix prefer the
  replica that last served that prefix, but only while its outstanding
  work stays within ``affinity_slack`` REQUESTS of the least-loaded
  choice — affinity is a locality hint (warm compiled buckets today,
  prefix-cache reuse when the paged-KV work lands), never a license to
  pile onto a hot replica.

Ties break on replica name, so dispatch is deterministic for tests and
replayable chaos runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

#: prompt tokens hashed into the affinity key: long enough to separate
#: real system prompts, short enough that near-identical prompts collide
#: into the same warm replica.  When the fleet serves PAGED engines,
#: construct the router with ``page_size=<engine page_size>`` instead:
#: the key then becomes the first full KV page of the prompt — the
#: minimal unit the radix prefix cache can share — so affinity routing
#: sends same-system-prompt requests to the replica that already holds
#: their prefix pages, and the hint pays off as REAL ``prefix_hits``
#: instead of just warm compiled buckets.
DEFAULT_PREFIX_TOKENS = 8


def prefix_key(prompt: Sequence[int],
               n: int = DEFAULT_PREFIX_TOKENS) -> Tuple[int, ...]:
    """The affinity key for a prompt: its first ``n`` token ids."""
    return tuple(int(t) for t in list(prompt)[:n])


def radix_prefix_key(prompt: Sequence[int],
                     page_size: int) -> Tuple[int, ...]:
    """The paged affinity key: the prompt's first full KV page (or the
    whole prompt when it is shorter than one page — too short to share
    pages, but still a stable identity for bucket warmth)."""
    return tuple(int(t) for t in list(prompt)[:max(int(page_size), 1)])


def replica_load(snapshot: Dict[str, Any],
                 default_pace: float = 1.0) -> float:
    """Estimated drain cost of a replica from its snapshot.

    ``(queue_depth + occupied slots)`` requests ahead, each paced at
    the replica's observed ``tpot_p95_s`` when it has one and at
    ``default_pace`` otherwise.  Callers comparing replicas should pass
    the fleet's typical pace as the default (see :meth:`Router.rank`):
    a just-re-formed replica has no samples yet, and scoring it with an
    arbitrary large constant would make the idle rebuilt replica look
    busier than saturated survivors — starving exactly the capacity the
    heal just restored."""
    depth = int(snapshot.get("queue_depth", 0))
    occupied = int(snapshot.get("slots", 0)) - int(
        snapshot.get("free_slots", 0)
    )
    pace = snapshot.get("tpot_p95_s") or default_pace
    return (depth + max(occupied, 0)) * float(pace)


def _outstanding(snapshot: Dict[str, Any]) -> int:
    """Outstanding work in requests: queued plus occupied slots."""
    occupied = int(snapshot.get("slots", 0)) - int(
        snapshot.get("free_slots", 0)
    )
    return int(snapshot.get("queue_depth", 0)) + max(occupied, 0)


def _typical_pace(snapshots: Sequence[Dict[str, Any]]) -> float:
    """Median observed ``tpot_p95_s`` across snapshots that have one;
    1.0 when nobody has samples yet (all-cold fleets compare by raw
    depth, which is the right cold-start behavior)."""
    paces = sorted(
        float(s["tpot_p95_s"]) for s in snapshots
        if s.get("tpot_p95_s")
    )
    if not paces:
        return 1.0
    return paces[len(paces) // 2]


class Router:
    """Least-loaded + prefix-affinity dispatch over replica snapshots."""

    def __init__(self, affinity_slack: float = 2.0,
                 prefix_tokens: int = DEFAULT_PREFIX_TOKENS,
                 max_affinity: int = 4096,
                 page_size: Optional[int] = None):
        if affinity_slack < 0:
            raise ValueError(
                f"affinity_slack must be >= 0, got {affinity_slack}"
            )
        self.affinity_slack = float(affinity_slack)
        # page_size aligns the affinity key with the radix prefix
        # cache's sharing unit (one full page): requests that CAN share
        # pages get the same key, so sticking them to one replica turns
        # the locality hint into real prefix_hits there
        self.page_size = None if page_size is None else int(page_size)
        self.prefix_tokens = (
            int(prefix_tokens) if self.page_size is None
            else self.page_size
        )
        self.max_affinity = int(max_affinity)
        # prefix key -> replica name; plain dict, insertion-ordered, so
        # the cap evicts the oldest learned affinity first
        self._affinity: Dict[Tuple[int, ...], str] = {}

    def _key(self, prompt: Sequence[int]) -> Tuple[int, ...]:
        """The affinity key: radix-aligned (first full KV page) on
        paged fleets, first-``prefix_tokens`` otherwise."""
        if self.page_size is not None:
            return radix_prefix_key(prompt, self.page_size)
        return prefix_key(prompt, self.prefix_tokens)

    # --- ranking -----------------------------------------------------------
    def rank(self, snapshots: Sequence[Dict[str, Any]],
             prompt: Optional[Sequence[int]] = None,
             role: Optional[str] = None) -> List[str]:
        """Replica names, best dispatch target first.

        Only snapshots marked ``healthy`` participate.  With ``role``
        set (disaggregated fleets), only replicas carrying that role
        compete — prefill work never lands on a decode specialist and
        vice versa; role-less fleets pass None and rank everyone.  With
        a prompt, the learned affinity replica is promoted to the front
        while its outstanding request count stays within
        ``affinity_slack`` requests of the least-loaded candidate — on
        a paged fleet the key is the prompt's first full KV page, so
        role-aware prefill placement follows page-aligned prefix
        affinity.  The full ranking (not just the winner) lets the
        fleet walk the list when the best target's bounded queue
        rejects."""
        healthy = [s for s in snapshots if s.get("healthy")]
        if role is not None:
            healthy = [s for s in healthy
                       if str(s.get("role", "")) == str(role)]
        if not healthy:
            return []
        pace = _typical_pace(healthy)
        ordered = sorted(
            healthy,
            key=lambda s: (replica_load(s, pace), str(s["name"])),
        )
        names = [str(s["name"]) for s in ordered]
        if prompt is not None:
            key = self._key(prompt)
            sticky = self._affinity.get(key)
            if sticky is not None and sticky in names:
                by_name = {str(s["name"]): s for s in healthy}
                # the slack is in REQUESTS (outstanding-work counts),
                # not pace-scaled load: scaled, a realistic ~20ms TPOT
                # would let the sticky replica carry ~slack/0.02 ≈ 100
                # extra requests before yielding — an unbounded pile-on
                # wearing a bounded constant's name
                best_count = _outstanding(ordered[0])
                if (_outstanding(by_name[sticky])
                        <= best_count + self.affinity_slack):
                    names.remove(sticky)
                    names.insert(0, sticky)
        return names

    def choose(self, snapshots: Sequence[Dict[str, Any]],
               prompt: Optional[Sequence[int]] = None,
               role: Optional[str] = None) -> Optional[str]:
        """The single best dispatch target, or None with no healthy
        replica (in the requested role, when one is given)."""
        ranked = self.rank(snapshots, prompt, role=role)
        return ranked[0] if ranked else None

    # --- affinity bookkeeping ----------------------------------------------
    def record_dispatch(self, replica_name: str,
                        prompt: Sequence[int]) -> None:
        """Learn (or refresh) the prefix -> replica affinity after an
        actual dispatch — the router only trusts placements that
        happened, not ones it merely suggested."""
        key = self._key(prompt)
        # re-insert so the cap below evicts least-recently-dispatched
        self._affinity.pop(key, None)
        self._affinity[key] = str(replica_name)
        while len(self._affinity) > self.max_affinity:
            self._affinity.pop(next(iter(self._affinity)))

    def forget_replica(self, replica_name: str) -> int:
        """Drop every affinity pointing at ``replica_name`` (it died or
        was evicted); returns how many entries were dropped."""
        stale = [k for k, v in self._affinity.items()
                 if v == str(replica_name)]
        for k in stale:
            del self._affinity[k]
        return len(stale)

    @property
    def affinity_size(self) -> int:
        return len(self._affinity)


__all__ = [
    "DEFAULT_PREFIX_TOKENS",
    "Router",
    "prefix_key",
    "radix_prefix_key",
    "replica_load",
]
