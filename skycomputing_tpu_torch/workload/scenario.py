"""Seeded, replayable workload scenarios: named phases -> arrival traces.

Every bench in this repo used to improvise its own traffic with an
inline rng loop, which made "handles as many scenarios as you can
imagine" untestable: a workload that only exists inside one bench's
``while`` loop cannot be replayed by the next bench, pinned by a test,
or named in a bug report.  This module makes the workload a VALUE:

- :class:`Dist` — a tiny declarative integer distribution (constant /
  uniform / weighted choice), sampled from the scenario's single seeded
  ``random.Random`` stream;
- :class:`Phase` — one named traffic regime: duration in ticks, arrival
  rate (requests/tick, fractional rates accumulate deterministically),
  prompt/decode length distributions, a priority-class mix, and an
  optional shared-prefix pool draw (RAG-style traffic);
- :class:`Scenario` — an ordered list of phases plus prefix pools and a
  vocab range.  :meth:`Scenario.arrivals` lowers the whole scenario to
  a flat, deterministic arrival trace — every token of every prompt is
  drawn from ONE ``random.Random(seed)`` in one documented order, so
  the same seed is byte-for-byte the same workload, forever.

**Seeding contract** (what replayability means here): one
``random.Random(seed)``, consumed in this exact order — (1) prefix
pools, in sorted pool-name order, each member's tokens in index order;
(2) phases in declaration order; (3) within a phase, ticks in order;
(4) within a tick, each arrival draws priority, then the shared-prefix
coin + pool pick, then the fresh prompt length, then its tokens, then
``max_new_tokens``.  Changing any phase parameter changes the stream
from that point on — which is the point: a scenario IS its trace.
:meth:`Scenario.digest` hashes the trace so identity checks are one
string comparison.

PURE STDLIB BY CONTRACT (the ``router.py`` / ``slo.py`` idiom):
loadable by file path with neither torch nor numpy installed —
``tests/test_torch_workload.py`` loads it so.  Materializing numpy
prompts and driving a real fleet live one module over, in
:mod:`.player`.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: priority classes mirrored from fleet.admission (duck-typed string
#: ids — this module must not import the fleet to stay stdlib/file-path
#: loadable; the admission controller validates them again at submit)
INTERACTIVE = "interactive"
BATCH = "batch"
_KNOWN_PRIORITIES = (INTERACTIVE, BATCH)


@dataclass(frozen=True)
class Dist:
    """A declarative distribution over positive ints.

    ``kind`` is one of ``constant`` (always ``lo``), ``uniform``
    (inclusive ``[lo, hi]``), or ``choice`` (``values`` with optional
    ``weights`` — the heavy-tail building block ``length_skew`` uses).
    Use the factory classmethods; they validate once at construction so
    a malformed scenario dies at build time, not mid-trace.
    """

    kind: str
    lo: int = 0
    hi: int = 0
    values: Tuple[int, ...] = ()
    weights: Tuple[float, ...] = ()

    @classmethod
    def constant(cls, value: int) -> "Dist":
        if int(value) < 1:
            raise ValueError(f"constant Dist needs value >= 1, got {value}")
        return cls("constant", lo=int(value))

    @classmethod
    def uniform(cls, lo: int, hi: int) -> "Dist":
        if not (1 <= int(lo) <= int(hi)):
            raise ValueError(
                f"uniform Dist needs 1 <= lo <= hi, got [{lo}, {hi}]"
            )
        return cls("uniform", lo=int(lo), hi=int(hi))

    @classmethod
    def choice(cls, values: Sequence[int],
               weights: Optional[Sequence[float]] = None) -> "Dist":
        vals = tuple(int(v) for v in values)
        if not vals or any(v < 1 for v in vals):
            raise ValueError(
                f"choice Dist needs a non-empty list of ints >= 1, "
                f"got {values!r}"
            )
        w = tuple(float(x) for x in (weights or ()))
        if w and (len(w) != len(vals) or any(x <= 0 for x in w)):
            raise ValueError(
                f"choice weights must be positive and match values "
                f"({len(vals)}), got {weights!r}"
            )
        return cls("choice", values=vals, weights=w)

    def sample(self, rng: random.Random) -> int:
        if self.kind == "constant":
            return self.lo
        if self.kind == "uniform":
            return rng.randint(self.lo, self.hi)
        if self.weights:
            return rng.choices(self.values, weights=self.weights, k=1)[0]
        return self.values[rng.randrange(len(self.values))]

    @property
    def max_value(self) -> int:
        """Upper bound of the support (bench sizing reads this to pick
        buckets that hold every arrival the scenario can emit)."""
        if self.kind == "constant":
            return self.lo
        if self.kind == "uniform":
            return self.hi
        return max(self.values)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind}
        if self.kind in ("constant", "uniform"):
            out["lo"] = self.lo
        if self.kind == "uniform":
            out["hi"] = self.hi
        if self.kind == "choice":
            out["values"] = list(self.values)
            if self.weights:
                out["weights"] = list(self.weights)
        return out


@dataclass(frozen=True)
class PrefixPool:
    """A pool of shared prompt prefixes (the RAG/system-prompt shape:
    many requests open with one of a few hot documents)."""

    members: int
    length: Dist

    def __post_init__(self):
        if int(self.members) < 1:
            raise ValueError(
                f"a prefix pool needs >= 1 members, got {self.members}"
            )


@dataclass(frozen=True)
class Phase:
    """One named traffic regime inside a scenario."""

    name: str
    ticks: int
    arrival_rate: float
    prompt_len: Dist
    new_tokens: Dist
    #: priority class -> weight; normalized at draw time
    priority_mix: Tuple[Tuple[str, float], ...] = ((BATCH, 1.0),)
    #: (pool name, fraction of arrivals that draw a shared prefix)
    shared_prefix: Optional[Tuple[str, float]] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("a phase needs a name")
        if int(self.ticks) < 1:
            raise ValueError(
                f"phase {self.name!r} needs ticks >= 1, got {self.ticks}"
            )
        if float(self.arrival_rate) < 0:
            raise ValueError(
                f"phase {self.name!r} arrival_rate must be >= 0, got "
                f"{self.arrival_rate}"
            )
        if not self.priority_mix:
            raise ValueError(f"phase {self.name!r} has an empty "
                             f"priority_mix")
        for prio, weight in self.priority_mix:
            if prio not in _KNOWN_PRIORITIES:
                raise ValueError(
                    f"phase {self.name!r} names unknown priority "
                    f"{prio!r}; known: {list(_KNOWN_PRIORITIES)}"
                )
            if float(weight) <= 0:
                raise ValueError(
                    f"phase {self.name!r} priority weight for {prio!r} "
                    f"must be > 0, got {weight}"
                )
        if self.shared_prefix is not None:
            pool, fraction = self.shared_prefix
            if not pool:
                raise ValueError(
                    f"phase {self.name!r} shared_prefix needs a pool name"
                )
            if not 0.0 < float(fraction) <= 1.0:
                raise ValueError(
                    f"phase {self.name!r} shared_prefix fraction must be "
                    f"in (0, 1], got {fraction}"
                )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(
            name=self.name, ticks=self.ticks,
            arrival_rate=self.arrival_rate,
            prompt_len=self.prompt_len.to_dict(),
            new_tokens=self.new_tokens.to_dict(),
            priority_mix={p: w for p, w in self.priority_mix},
        )
        if self.shared_prefix is not None:
            out["shared_prefix"] = dict(
                pool=self.shared_prefix[0],
                fraction=self.shared_prefix[1],
            )
        return out


@dataclass(frozen=True)
class Arrival:
    """One request the scenario emits: WHEN it arrives and WHAT it is.

    ``prompt`` is the literal token ids (a tuple — hashable, byte-
    comparable); ``prefix_len`` > 0 marks the leading shared-prefix
    span and names its pool, so players and benches can assert prefix
    reuse without re-deriving the trace."""

    tick: int
    phase: str
    prompt: Tuple[int, ...]
    new_tokens: int
    priority: str = BATCH
    prefix_pool: Optional[str] = None
    prefix_len: int = 0

    def key(self) -> Tuple:
        """The byte-identity view (what :meth:`Scenario.digest` hashes
        and the determinism tests compare)."""
        return (self.tick, self.phase, self.prompt, self.new_tokens,
                self.priority, self.prefix_pool, self.prefix_len)


def trace_digest(arrivals: Sequence[Arrival]) -> str:
    """sha256 over an already-materialized trace (what
    :meth:`Scenario.digest` hashes; callers holding the arrivals —
    the player does — hash them directly instead of paying a second
    full trace generation)."""
    h = hashlib.sha256()
    for arrival in arrivals:
        h.update(repr(arrival.key()).encode())
    return h.hexdigest()


@dataclass(frozen=True)
class Scenario:
    """A named, seeded workload: phases + prefix pools + a vocab range.

    ``vocab`` is ``(lo, hi)`` — token ids are drawn from
    ``[lo, hi)``; keep ``lo >= 1`` so scenarios never emit the padding
    id.  The scenario object is immutable and cheap; the trace is
    computed by :meth:`arrivals` (pure function of the fields)."""

    name: str
    seed: int
    phases: Tuple[Phase, ...]
    vocab: Tuple[int, int] = (1, 500)
    prefix_pools: Tuple[Tuple[str, PrefixPool], ...] = ()
    description: str = ""

    def __post_init__(self):
        if not self.phases:
            raise ValueError(f"scenario {self.name!r} has no phases")
        lo, hi = self.vocab
        if not (1 <= int(lo) < int(hi)):
            raise ValueError(
                f"scenario {self.name!r} vocab must satisfy "
                f"1 <= lo < hi, got {self.vocab}"
            )
        pools = dict(self.prefix_pools)
        for phase in self.phases:
            if (phase.shared_prefix is not None
                    and phase.shared_prefix[0] not in pools):
                raise ValueError(
                    f"phase {phase.name!r} references unknown prefix "
                    f"pool {phase.shared_prefix[0]!r}; declared: "
                    f"{sorted(pools)}"
                )

    # --- derived sizing (bench/bucket feasibility reads these) --------------
    @property
    def total_ticks(self) -> int:
        return sum(p.ticks for p in self.phases)

    @property
    def max_prompt_len(self) -> int:
        """Longest prompt this scenario can emit (shared prefix + fresh
        tail) — the bound bench bucket sets must cover."""
        pools = dict(self.prefix_pools)
        worst = 0
        for phase in self.phases:
            tail = phase.prompt_len.max_value
            prefix = 0
            if phase.shared_prefix is not None:
                prefix = pools[phase.shared_prefix[0]].length.max_value
            worst = max(worst, prefix + tail)
        return worst

    @property
    def max_new_tokens(self) -> int:
        return max(p.new_tokens.max_value for p in self.phases)

    # --- the trace ----------------------------------------------------------
    def _materialize_pools(
        self, rng: random.Random
    ) -> Dict[str, List[Tuple[int, ...]]]:
        lo, hi = self.vocab
        pools: Dict[str, List[Tuple[int, ...]]] = {}
        for pool_name, pool in sorted(self.prefix_pools):
            members = []
            for _ in range(pool.members):
                n = pool.length.sample(rng)
                members.append(
                    tuple(rng.randrange(lo, hi) for _ in range(n))
                )
            pools[pool_name] = members
        return pools

    def arrivals(self) -> List[Arrival]:
        """Lower the scenario to its deterministic arrival trace.

        Pure: two calls (or two processes, or two years) with the same
        scenario fields return identical traces — the replayability
        contract every test and bench leans on."""
        rng = random.Random(self.seed)
        pools = self._materialize_pools(rng)
        lo, hi = self.vocab
        out: List[Arrival] = []
        tick = 0
        for phase in self.phases:
            prios = [p for p, _ in phase.priority_mix]
            weights = [w for _, w in phase.priority_mix]
            acc = 0.0
            for _ in range(phase.ticks):
                acc += phase.arrival_rate
                due = int(acc)
                acc -= due
                for _ in range(due):
                    priority = rng.choices(prios, weights=weights,
                                           k=1)[0]
                    prefix: Tuple[int, ...] = ()
                    pool_name = None
                    if (phase.shared_prefix is not None
                            and rng.random()
                            < phase.shared_prefix[1]):
                        pool_name = phase.shared_prefix[0]
                        members = pools[pool_name]
                        prefix = members[rng.randrange(len(members))]
                    tail_n = phase.prompt_len.sample(rng)
                    tail = tuple(rng.randrange(lo, hi)
                                 for _ in range(tail_n))
                    out.append(Arrival(
                        tick=tick, phase=phase.name,
                        prompt=prefix + tail,
                        new_tokens=phase.new_tokens.sample(rng),
                        priority=priority,
                        prefix_pool=pool_name,
                        prefix_len=len(prefix),
                    ))
                tick += 1
        return out

    def digest(self) -> str:
        """sha256 of the arrival trace — workload identity as one
        comparable string (committed into bench artifacts so drift in
        the generator is visible as a hash change)."""
        return trace_digest(self.arrivals())

    def to_dict(self) -> Dict[str, Any]:
        """The artifact/docs form: everything needed to re-declare the
        scenario (the trace itself is regenerable from this + seed)."""
        return dict(
            name=self.name, seed=self.seed,
            vocab=list(self.vocab),
            description=self.description,
            total_ticks=self.total_ticks,
            max_prompt_len=self.max_prompt_len,
            max_new_tokens=self.max_new_tokens,
            prefix_pools={
                name: dict(members=pool.members,
                           length=pool.length.to_dict())
                for name, pool in self.prefix_pools
            },
            phases=[p.to_dict() for p in self.phases],
        )

    def with_seed(self, seed: int) -> "Scenario":
        """The same named workload shape under a different seed (the
        catalog's ``seed=`` plumbing)."""
        return Scenario(
            name=self.name, seed=int(seed), phases=self.phases,
            vocab=self.vocab, prefix_pools=self.prefix_pools,
            description=self.description,
        )


# --------------------------------------------------------------------------
# the named-scenario catalog
# --------------------------------------------------------------------------
#
# One ``--scenario`` flag per workload: every entry is a zero-ceremony
# builder ``(seed=0, rate_scale=1.0, ticks_scale=1.0) -> Scenario``
# registered under a stable name, so a bench, a test, or a bug report
# can say ``diurnal_ramp @ seed 7`` and mean exactly one byte-identical
# workload.  The catalog ships the five shapes the ROADMAP names (the
# mixes serving claims live or die under — vLLM's lesson is that a
# claim proven on one rng loop collapses under shared prefixes or
# length skew):
#
# - ``diurnal_ramp`` — the daily tide: quiet night, morning ramp, an
#   overloading midday peak, evening decay.  The autoscaler's
#   acceptance scenario: sustained burn up, sustained slack after.
# - ``flash_crowd`` — a calm baseline broken by a sudden short spike at
#   many times the base rate; tests hysteresis — one noisy burst must
#   not flap the fleet.
# - ``tenant_mix`` — interleaved interactive/batch priority classes;
#   what the admission shed band is actually for.
# - ``rag_shared_prefix`` — most arrivals open with one of a few hot
#   documents from a shared pool; what prefix-affinity routing and
#   radix prefix reuse are actually for.
# - ``length_skew`` — adversarial heavy-tailed prompt lengths; what
#   chunked prefill and bucket padding discipline are actually for.
# - ``disagg_mix`` — alternating long-prompt/short-decode and
#   short-prompt/long-decode regimes; the workload disaggregated
#   prefill/decode pools (and their per-pool autoscaling) are for.
#
# Sizing contract: defaults are sized for this repo's CPU bench harness
# (tiny GPT, buckets up to 96, ~2 decode slots per replica ≈ 0.1
# requests/tick of service rate per replica).  ``rate_scale``
# multiplies every phase's arrival rate and ``ticks_scale`` every
# phase's duration, so the same shape scales to bigger fleets without
# re-declaring it.  The registry lives HERE (not a sibling module) so
# the whole scenario plane stays ONE self-contained stdlib file the CI
# smoke loads by path; :mod:`.catalog` re-exports it for package users.

#: name -> builder; insertion order is the documented catalog order
SCENARIOS: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register a scenario builder under ``name`` (benches
    and tools resolve ``--scenario`` flags against this registry)."""

    def deco(fn: Callable[..., Scenario]):
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} is already registered")
        SCENARIOS[name] = fn
        return fn

    return deco


def scenario_names() -> List[str]:
    return list(SCENARIOS)


def get_scenario(name: str, seed: int = 0, *, rate_scale: float = 1.0,
                 ticks_scale: float = 1.0) -> Scenario:
    """Build a named scenario; unknown names fail with the catalog in
    the message (the ``--scenario`` flag's error surface)."""
    builder = SCENARIOS.get(name)
    if builder is None:
        raise ValueError(
            f"unknown scenario {name!r}; catalog: {scenario_names()}"
        )
    return builder(seed=seed, rate_scale=rate_scale,
                   ticks_scale=ticks_scale)


def _ticks(base: int, scale: float) -> int:
    return max(1, int(round(base * scale)))


@register_scenario("diurnal_ramp")
def diurnal_ramp(seed: int = 0, rate_scale: float = 1.0,
                 ticks_scale: float = 1.0) -> Scenario:
    prompt = Dist.uniform(8, 48)
    new = Dist.uniform(8, 20)
    mix = ((INTERACTIVE, 0.5), (BATCH, 0.5))

    def phase(name, ticks, rate):
        return Phase(name=name, ticks=_ticks(ticks, ticks_scale),
                     arrival_rate=rate * rate_scale,
                     prompt_len=prompt, new_tokens=new,
                     priority_mix=mix)

    return Scenario(
        name="diurnal_ramp", seed=seed,
        phases=(
            phase("night", 40, 0.06),
            phase("morning", 40, 0.16),
            phase("peak", 70, 0.42),
            phase("evening", 40, 0.16),
            phase("late_night", 60, 0.05),
        ),
        description="daily tide: quiet -> ramp -> overloading peak -> "
                    "decay; the autoscaler acceptance scenario",
    )


@register_scenario("flash_crowd")
def flash_crowd(seed: int = 0, rate_scale: float = 1.0,
                ticks_scale: float = 1.0) -> Scenario:
    prompt = Dist.uniform(8, 40)
    new = Dist.uniform(8, 16)

    def phase(name, ticks, rate, mix=((BATCH, 1.0),)):
        return Phase(name=name, ticks=_ticks(ticks, ticks_scale),
                     arrival_rate=rate * rate_scale,
                     prompt_len=prompt, new_tokens=new,
                     priority_mix=mix)

    return Scenario(
        name="flash_crowd", seed=seed,
        phases=(
            phase("calm", 50, 0.08),
            phase("crowd", 20, 0.8,
                  mix=((INTERACTIVE, 0.8), (BATCH, 0.2))),
            phase("aftermath", 60, 0.08),
        ),
        description="calm baseline broken by a sudden 10x interactive "
                    "spike; hysteresis must not flap the fleet",
    )


@register_scenario("tenant_mix")
def tenant_mix(seed: int = 0, rate_scale: float = 1.0,
               ticks_scale: float = 1.0) -> Scenario:
    prompt = Dist.uniform(8, 44)

    def phase(name, ticks, rate, mix, new):
        return Phase(name=name, ticks=_ticks(ticks, ticks_scale),
                     arrival_rate=rate * rate_scale,
                     prompt_len=prompt, new_tokens=new,
                     priority_mix=mix)

    return Scenario(
        name="tenant_mix", seed=seed,
        phases=(
            phase("balanced", 60, 0.14,
                  ((INTERACTIVE, 0.5), (BATCH, 0.5)),
                  Dist.uniform(8, 16)),
            phase("batch_backfill", 50, 0.22,
                  ((INTERACTIVE, 0.2), (BATCH, 0.8)),
                  Dist.uniform(12, 24)),
            phase("interactive_rush", 50, 0.2,
                  ((INTERACTIVE, 0.85), (BATCH, 0.15)),
                  Dist.uniform(8, 14)),
        ),
        description="multi-tenant priority mixes: the shed band must "
                    "degrade batch first, interactive last",
    )


@register_scenario("rag_shared_prefix")
def rag_shared_prefix(seed: int = 0, rate_scale: float = 1.0,
                      ticks_scale: float = 1.0) -> Scenario:
    return Scenario(
        name="rag_shared_prefix", seed=seed,
        prefix_pools=(
            ("kb_docs", PrefixPool(members=4,
                                   length=Dist.uniform(16, 28))),
        ),
        phases=(
            Phase(name="retrieval_storm",
                  ticks=_ticks(110, ticks_scale),
                  arrival_rate=0.18 * rate_scale,
                  prompt_len=Dist.uniform(4, 20),
                  new_tokens=Dist.uniform(8, 16),
                  priority_mix=((INTERACTIVE, 0.7), (BATCH, 0.3)),
                  shared_prefix=("kb_docs", 0.8)),
        ),
        description="RAG-style traffic: 80% of arrivals open with one "
                    "of 4 hot documents; prefix affinity + radix reuse "
                    "territory",
    )


@register_scenario("length_skew")
def length_skew(seed: int = 0, rate_scale: float = 1.0,
                ticks_scale: float = 1.0) -> Scenario:
    # heavy tail: ~82% short, ~15% medium, ~3% near the bucket limit —
    # the adversarial mix where one giant prefill wave starves decode
    skewed = Dist.choice(
        values=(8, 12, 16, 24, 40, 80),
        weights=(30.0, 28.0, 24.0, 10.0, 5.0, 3.0),
    )
    return Scenario(
        name="length_skew", seed=seed,
        phases=(
            Phase(name="skewed", ticks=_ticks(110, ticks_scale),
                  arrival_rate=0.16 * rate_scale,
                  prompt_len=skewed,
                  new_tokens=Dist.uniform(6, 12),
                  priority_mix=((INTERACTIVE, 0.5), (BATCH, 0.5))),
        ),
        description="adversarial prompt-length skew: mostly short, a "
                    "thin band of near-bucket-limit giants",
    )


@register_scenario("disagg_mix")
def disagg_mix(seed: int = 0, rate_scale: float = 1.0,
               ticks_scale: float = 1.0) -> Scenario:
    # disaggregation's home turf: phases where the BOTTLENECK PHASE
    # flips — long-prompt/short-decode waves (prefill-bound: summarize,
    # classify) interleaved with short-prompt/long-decode streams
    # (decode-bound: chat) — so a monolithic pool thrashes between
    # operating points while role pools each stay on theirs
    def phase(name, ticks, rate, prompt, new, mix):
        return Phase(name=name, ticks=_ticks(ticks, ticks_scale),
                     arrival_rate=rate * rate_scale,
                     prompt_len=prompt, new_tokens=new,
                     priority_mix=mix)

    return Scenario(
        name="disagg_mix", seed=seed,
        phases=(
            phase("ingest_wave", 50, 0.14,
                  Dist.uniform(40, 80), Dist.uniform(4, 8),
                  ((INTERACTIVE, 0.3), (BATCH, 0.7))),
            phase("mixed", 40, 0.16,
                  Dist.uniform(12, 48), Dist.uniform(8, 16),
                  ((INTERACTIVE, 0.5), (BATCH, 0.5))),
            phase("chat_stream", 50, 0.14,
                  Dist.uniform(6, 16), Dist.uniform(20, 32),
                  ((INTERACTIVE, 0.7), (BATCH, 0.3))),
        ),
        description="long-prompt/short-decode waves interleaved with "
                    "short-prompt/long-decode streams; the disaggregated "
                    "prefill/decode acceptance workload",
    )


__all__ = [
    "Arrival",
    "BATCH",
    "Dist",
    "trace_digest",
    "INTERACTIVE",
    "Phase",
    "PrefixPool",
    "SCENARIOS",
    "Scenario",
    "get_scenario",
    "register_scenario",
    "scenario_names",
]
