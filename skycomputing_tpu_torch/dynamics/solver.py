"""Contiguous layer->device partition solver (the port's own copy of
``skycomputing_tpu/dynamics/solver.py``: host code, stdlib only, with
the same native core in ``native/``, and the mesh-native engine's
mesh-shape search, :func:`solve_mesh_shapes`).

Every result names the path that produced it (``PartitionResult.path``):
``native_exact`` (the C++ subset DP), ``native_classes`` (the C++
count-vector DP over speed classes), ``native_anneal`` (the C++ order
anneal), or, where the native core did not build, ``python_exact`` /
``python_greedy`` — the same search in Python, logged once by
:mod:`.native` when the build fails.

The reference formulates allocation as a binary MIP
(``scaelum/dynamics/allocator.py:47-132``): assign each layer to exactly one
device, each device's layers contiguous, per-device memory capacity respected,
minimizing the max device time ``q = dt[d] * sum(flops of its layers)``, and
shells out to CBC/Gurobi via pulp.  Neither pulp nor a native MIP solver is
available here, and none is needed: with contiguity + free device ordering
the problem is "partition a sequence into <= D contiguous slices assigned to
distinct heterogeneous devices, minimizing the bottleneck".  For a fixed
bottleneck T, feasibility is decided *exactly* by a subset DP with a
max-frontier dominance (reachable frontier is monotone in start index), and
the optimal T is found by binary search.  Exact for clusters up to
``exact_limit`` devices (2^D * D per probe); beyond that a randomized
max-coverage greedy takes over, polished by local search and — when a
certified optimality gap remains — time-boxed simulated annealing over the
device order with an exact per-order evaluator.  Every result carries an
*integral lower bound* (:func:`integral_lower_bound`): the max-window
capacity relaxation that, unlike a fractional waterfilling bound, respects
layer integrality, so large-cluster solutions can be certified optimal (the
paper-scale 64-device instances solve to gap 0).  If pulp happens to be
importable it is used as a cross-check oracle in tests, never as the
primary path.
"""

from __future__ import annotations

import bisect
import heapq
import math
import random
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class PartitionResult:
    """Slices per device, device order = pipeline order.

    ``slices[i] = (start, end)`` half-open layer range for the device at
    pipeline position i; ``device_order[i]`` is the index (into the input
    device arrays) of that device.  Devices left empty are omitted.

    ``lower_bound`` is a *certified* integral lower bound on the bottleneck
    (see :func:`integral_lower_bound`): no assignment — contiguous or not —
    can beat it, so ``bottleneck <= lower_bound * (1 + gap)`` certifies the
    solution within ``gap`` of optimal.  The reference's CBC MIP reported
    the same kind of bound via its 20% relative-gap setting
    (``scaelum/dynamics/allocator.py:109-132``).
    """

    device_order: List[int]
    slices: List[Tuple[int, int]]
    bottleneck: float
    lower_bound: float = 0.0
    path: str = ""

    @property
    def optimality_gap(self) -> float:
        """Relative gap vs the certified bound (0.0 = provably optimal)."""
        if self.lower_bound <= 0.0:
            return float("inf")
        return max(0.0, self.bottleneck / self.lower_bound - 1.0)

    def as_ranges(self, num_devices: int) -> List[Optional[Tuple[int, int]]]:
        out: List[Optional[Tuple[int, int]]] = [None] * num_devices
        for d, s in zip(self.device_order, self.slices):
            out[d] = s
        return out


def _prefix(values: Sequence[float]) -> List[float]:
    acc = [0.0]
    for v in values:
        acc.append(acc[-1] + float(v))
    return acc


class _CoverTable:
    """cover(l, d): furthest layer index reachable from l on device d."""

    def __init__(self, layer_cost, layer_mem, device_time, device_mem):
        self.cost_prefix = _prefix(layer_cost)
        self.mem_prefix = _prefix(layer_mem)
        self.device_time = list(device_time)
        self.device_mem = list(device_mem)
        self.num_layers = len(layer_cost)

    def cover(self, start: int, d: int, T: float) -> int:
        if start >= self.num_layers:
            return self.num_layers
        dt = self.device_time[d]
        cost_budget = T / dt if dt > 0 else float("inf")
        # furthest r with cost_prefix[r] <= cost_prefix[start] + budget
        r_cost = (
            bisect.bisect_right(
                self.cost_prefix, self.cost_prefix[start] + cost_budget + 1e-12
            )
            - 1
        )
        r_mem = (
            bisect.bisect_right(
                self.mem_prefix, self.mem_prefix[start] + self.device_mem[d] + 1e-9
            )
            - 1
        )
        return max(start, min(r_cost, r_mem))


def _max_window_cost(table: _CoverTable, d: int, T: float,
                     a: int, b: int) -> float:
    """Max cost of a contiguous window within layers ``[a, b)`` that device
    d could hold at threshold T.

    Upper-bounds the contribution of device d to *any* feasible assignment
    (its slice is one such window), and — unlike a fractional waterfilling
    bound — respects layer integrality: a device with budget 1.9
    layer-costs covers at most the best real window under 1.9, not 1.9
    fractional layers.
    """
    cp, mp = table.cost_prefix, table.mem_prefix
    dt = table.device_time[d]
    cost_budget = T / dt if dt > 0 else float("inf")
    mem_budget = table.device_mem[d]
    best = 0.0
    r = a
    for start in range(a, b):
        if r < start:
            r = start
        while (
            r < b
            and cp[r + 1] - cp[start] <= cost_budget + 1e-12
            and mp[r + 1] - mp[start] <= mem_budget + 1e-9
        ):
            r += 1
        best = max(best, cp[r] - cp[start])
        if r >= b:
            break
    return best


def integral_lower_bound(table: _CoverTable, hi: float,
                         iters: int = 48, num_separators: int = 6) -> float:
    """Largest T such that every T' < T is provably infeasible.

    Certificate: pick a layer as a *separator*.  In any feasible
    assignment exactly one device's slice contains it; every other device's
    slice is a contiguous window strictly left or right of it.  So if

        sum_d maxwin_d(avoiding sep) + max_d [maxwin_d(any) - maxwin_d(avoiding)]

    falls short of the total cost at threshold T, no assignment exists at
    T.  This is a relaxation (windows may overlap), hence a valid lower
    bound on the optimal bottleneck; the separator term closes the obvious
    over-count where every device claims the one expensive layer.

    The certificate is valid for ANY separator, so T is infeasible if any
    of the ``num_separators`` heaviest layers proves it — a strictly
    tighter (and still valid) bound than the single heaviest-layer choice,
    which matters on calibrated instances where several near-equal heavy
    layers exist (the refine loop's cost models).  Six separators (was 3)
    measurably tightens timed-profile instances — their heavy layers come
    in near-equal families (embeddings, the ffn shards) and the binding
    separator is not always among the top 3 — at a per-solve cost of
    milliseconds.
    """
    L = table.num_layers
    total = table.cost_prefix[L]
    costs = [
        table.cost_prefix[i + 1] - table.cost_prefix[i] for i in range(L)
    ]
    seps = sorted(range(L), key=lambda i: -costs[i])[: max(1, num_separators)]

    def infeasible_for(sep: int, T: float, full) -> bool:
        acc = 0.0
        best_bonus = 0.0
        for d in range(len(table.device_time)):
            avoiding = max(
                _max_window_cost(table, d, T, 0, sep),
                _max_window_cost(table, d, T, sep + 1, L),
            )
            acc += avoiding
            best_bonus = max(best_bonus, full[d] - avoiding)
            if acc + best_bonus >= total - 1e-9:
                return False
        return acc + best_bonus < total - 1e-9

    def infeasible(T: float) -> bool:
        # the full-range window cost is separator-independent: compute it
        # once per (T, device), shared by every separator certificate
        full = [
            _max_window_cost(table, d, T, 0, L)
            for d in range(len(table.device_time))
        ]
        return any(infeasible_for(sep, T, full) for sep in seps)

    lo, up = 0.0, hi
    if not infeasible(lo):
        return 0.0
    for _ in range(iters):
        mid = (lo + up) / 2.0
        if infeasible(mid):
            lo = mid
        else:
            up = mid
    return lo


def _fixed_order_walk(table: _CoverTable, order: Sequence[int], T: float):
    """Maximal-cover walk along a fixed device order; exact for that order.

    Taking the maximal cover at each position is optimal for a fixed order
    because ``cover`` is non-decreasing in its start argument (prefix sums
    are monotone), so ceding layers to a later device never helps.
    """
    pos = 0
    used: List[int] = []
    slices: List[Tuple[int, int]] = []
    for d in order:
        end = table.cover(pos, d, T)
        if end > pos:
            used.append(d)
            slices.append((pos, end))
            pos = end
            if pos >= table.num_layers:
                return used, slices
    return None


def _fixed_order_opt(table: _CoverTable, order: Sequence[int], lo: float,
                     hi: float, iters: int = 45):
    """Minimal bottleneck achievable with devices tried in ``order``."""
    sol = _fixed_order_walk(table, order, hi)
    if sol is None:
        return float("inf"), None
    best_T = hi
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        if hi - lo <= 1e-12 * max(hi, 1.0):
            break
        cand = _fixed_order_walk(table, order, mid)
        if cand is not None:
            sol, best_T, hi = cand, mid, mid
        else:
            lo = mid
    return best_T, sol


def _anneal_orders(table: _CoverTable, order, lower_bound: float,
                   rng: random.Random, init_bottleneck: float,
                   max_evals: int = 4000):
    """Simulated annealing over the *device order*, each order scored by its
    exact optimal slicing (binary search + maximal-cover walk).

    The greedy/local-search pipeline can misassign devices in ways single
    boundary shifts and pairwise swaps cannot repair; searching
    order-space with an exact per-order evaluator is the bound-guided
    repair: it stops as soon as the certified lower bound is reached.  The
    budget is purely an *evaluation count* so one pass is deterministic
    for a given seed regardless of machine speed (a wall-clock box would
    make same-seed runs diverge across machines); the caller enforces any
    wall cap BETWEEN passes, never inside one.

    Moves: random position swap, random move-insert, and a
    bottleneck-targeted swap that relocates the device currently pinning
    the exact evaluation — targeted repair converges far faster than blind
    permutation moves at 64-device scale.
    """
    D = len(table.device_time)
    used = list(order)
    rest = [d for d in range(D) if d not in set(used)]
    current = used + rest
    cur_val, cur_sol = _fixed_order_opt(
        table, current, lower_bound, init_bottleneck * (1 + 1e-9)
    )
    if cur_sol is None:
        return None
    best_val, best_sol = cur_val, cur_sol
    temp0 = max(cur_val - lower_bound, 1e-9)

    def bottleneck_position(sol) -> Optional[int]:
        """Index *in the current full order* of the device pinning sol."""
        s_order, s_slices = sol
        worst_d, worst_t = None, -1.0
        for d, (s, e) in zip(s_order, s_slices):
            t = table.device_time[d] * (
                table.cost_prefix[e] - table.cost_prefix[s]
            )
            if t > worst_t:
                worst_d, worst_t = d, t
        if worst_d is None:
            return None
        try:
            return current.index(worst_d)
        except ValueError:  # pragma: no cover - sol devices come from order
            return None

    for evals in range(max_evals):
        if best_val <= lower_bound * (1 + 1e-9):
            break
        frac = 1.0 - evals / max(max_evals, 1)
        temp = temp0 * 0.3 * frac + 1e-12
        cand = list(current)
        u = rng.random()
        if u < 0.4:
            i, j = rng.randrange(D), rng.randrange(D)
            cand[i], cand[j] = cand[j], cand[i]
        elif u < 0.7:
            i, j = rng.randrange(D), rng.randrange(D)
            cand.insert(j, cand.pop(i))
        else:
            i = bottleneck_position(cur_sol)
            if i is None:
                i = rng.randrange(D)
            j = rng.randrange(D)
            cand[i], cand[j] = cand[j], cand[i]
        val, sol = _fixed_order_opt(
            table, cand, lower_bound,
            max(best_val * (1 + 1e-9), cur_val * 1.25),
        )
        if sol is None:
            continue
        if val < cur_val or rng.random() < math.exp(-(val - cur_val) / temp):
            current, cur_val, cur_sol = cand, val, sol
            if val < best_val:
                best_val, best_sol = val, sol
    return best_sol


def _feasible_exact(table: _CoverTable, T: float):
    """Subset DP: frontier[mask] = furthest layer reachable using mask.

    Dominance is valid because cover(l, d) is non-decreasing in l (prefix
    sums are monotone), so only the max frontier per subset matters.
    Returns the assignment (device order + slices) or None.
    """
    D = len(table.device_time)
    L = table.num_layers
    size = 1 << D
    frontier = [0] * size
    choice = [-1] * size

    full_found = None
    for mask in range(1, size):
        best, best_d = 0, -1
        m = mask
        while m:
            low = m & (-m)
            d = low.bit_length() - 1
            m ^= low
            prev = frontier[mask ^ low]
            reach = table.cover(prev, d, T)
            if reach > best or best_d == -1:
                best, best_d = reach, d
        frontier[mask] = best
        choice[mask] = best_d
        if best >= L:
            full_found = mask
            break

    if full_found is None:
        return None

    # Backtrack: order of devices along the pipeline (reverse of peeling).
    order_rev: List[int] = []
    mask = full_found
    while mask:
        d = choice[mask]
        order_rev.append(d)
        mask ^= 1 << d
    order = list(reversed(order_rev))

    slices: List[Tuple[int, int]] = []
    pos = 0
    used_order: List[int] = []
    for d in order:
        end = table.cover(pos, d, T)
        if end > pos:
            slices.append((pos, end))
            used_order.append(d)
        pos = end
    if pos < L:  # pragma: no cover - backtrack must reproduce the DP
        return None
    return used_order, slices


def _feasible_greedy(table: _CoverTable, T: float, rng: random.Random,
                     attempts: int = 20):
    """Randomized max-coverage greedy for large device counts."""
    D = len(table.device_time)
    L = table.num_layers

    for attempt in range(attempts):
        remaining = set(range(D))
        pos = 0
        order: List[int] = []
        slices: List[Tuple[int, int]] = []
        while pos < L and remaining:
            covers = [(table.cover(pos, d, T), d) for d in remaining]
            best = max(c for c, _ in covers)
            if best <= pos:
                break
            if attempt == 0:
                _, d = max(covers)
            else:
                good = [d for c, d in covers if c >= pos + 0.9 * (best - pos)]
                d = rng.choice(good)
            end = table.cover(pos, d, T)
            order.append(d)
            slices.append((pos, end))
            remaining.discard(d)
            pos = end
        if pos >= L:
            return order, slices
    return None


def _solve_by_classes(
    layer_cost, layer_mem, device_time, device_mem, tolerance: float,
    max_classes: int = 8, max_states: int = 8_000_000,
):
    """Exact class-collapse solve (see native ``skytpu_solve_classes``).

    Devices sharing a slowdown form a class (exact equality — profiled
    per-device times collapse only when they really repeat, as the
    headline instances' integer slowdown draws do).  Two DP solves:

    - per-class MAX member memory: a relaxation of the real instance, so
      its exact optimum is a certified LOWER bound;
    - per-class MIN member memory: every produced slice fits every class
      member, so the partition maps to real devices — a feasible
      solution (an upper bound).

    With slack memory the two coincide: provably optimal, gap 0 — where
    the order-anneal left 2-6% certified gaps on noisy timed profiles.
    Returns ``(solution | None, bound | None)`` with ``solution`` a
    ``PartitionResult``-shaped tuple ``(device_order, slices,
    bottleneck)``; both None when the instance doesn't collapse (many
    distinct speeds) or the native core is unavailable.
    """
    groups: dict = {}
    for d, t in enumerate(device_time):
        groups.setdefault(float(t), []).append(d)
    D = len(device_time)
    if len(groups) > max_classes or len(groups) >= D:
        return None, None
    # fast classes first: the DP's early exit takes the lexicographically
    # smallest covering count-vector, which then spends slow devices last
    # — among equal-bottleneck optima, prefer the one that drops slow
    # workers (the allocation the schedule actually wants)
    class_dt = sorted(groups)
    members = [groups[t] for t in class_dt]
    counts = [len(m) for m in members]
    n_states = 1
    for c in counts:
        n_states *= c + 1
        if n_states > max_states:
            return None, None
    from . import native

    mem_max = [max(device_mem[d] for d in m) for m in members]
    mem_min = [min(device_mem[d] for d in m) for m in members]
    try:
        relaxed = native.solve_classes_native(
            layer_cost, layer_mem, counts, class_dt, mem_max,
            tolerance=min(tolerance, 1e-9), max_states=max_states,
        )
    except RuntimeError:
        # even with every class at max memory the model does not fit —
        # the real instance is infeasible too; let the main path raise
        # its canonical error
        return None, None
    if relaxed is None:
        return None, None
    bound = relaxed[2]
    try:
        tight = native.solve_classes_native(
            layer_cost, layer_mem, counts, class_dt, mem_min,
            tolerance=min(tolerance, 1e-9), max_states=max_states,
        )
    except RuntimeError:
        # memory-fragmented inside a class: the conservative solve has no
        # cover, but the bound above still stands for the anneal path
        return None, bound
    if tight is None:
        return None, bound
    classes, slices, bottleneck = tight
    # map class slices onto concrete devices: larger-memory members take
    # the larger slices (any assignment fits; this ordering keeps slack)
    mem_prefix = _prefix(layer_mem)
    by_class: dict = {
        k: sorted(m, key=lambda d: -device_mem[d])
        for k, m in enumerate(members)
    }
    slice_order = sorted(
        range(len(slices)),
        key=lambda i: -(mem_prefix[slices[i][1]] - mem_prefix[slices[i][0]]),
    )
    assigned = [None] * len(slices)
    taken: dict = {k: 0 for k in by_class}
    for i in slice_order:
        k = classes[i]
        assigned[i] = by_class[k][taken[k]]
        taken[k] += 1
    return (assigned, [tuple(s) for s in slices], bottleneck), bound


def solve_contiguous_minmax(
    layer_cost: Sequence[float],
    layer_mem: Sequence[float],
    device_time: Sequence[float],
    device_mem: Sequence[float],
    exact_limit: int = 12,
    tolerance: float = 1e-3,
    greedy_attempts: int = 20,
    seed: int = 0,
    use_native: bool = True,
    native_exact_limit: int = 18,
    anneal_seconds: float = 300.0,
    anneal_evals: int = 3000,
    anneal_rounds: int = 6,
    gap_target: float = 0.01,
    clock=time.monotonic,
) -> PartitionResult:
    """Minimize max_d device_time[d] * sum(layer_cost[slice_d]).

    Subject to: slices contiguous and disjoint, covering all layers; device
    order free; sum(layer_mem[slice_d]) <= device_mem[d]; empty devices
    allowed (reference MIP allows them too — constraint 4 with sum(x)=0).

    The exact subset-DP runs in the native C++ core when available
    (``dynamics/native`` — the CBC analog), extending the exact regime from
    ``exact_limit`` (pure Python) to ``native_exact_limit`` devices; the
    randomized greedy covers larger clusters either way.  The DP is
    exponential in D (~0.06s at D=14, ~1s at D=18, roughly x4.5 per +2
    devices on current hardware); raise ``native_exact_limit`` toward 22
    only if tens of seconds per allocation is acceptable — the reference
    gave its MIP solver a 300s budget, so that can be a fair trade.
    """
    D = len(device_time)
    L = len(layer_cost)
    if L == 0:
        return PartitionResult([], [], 0.0)
    if D == 0:
        raise ValueError("no devices")

    table = _CoverTable(layer_cost, layer_mem, device_time, device_mem)
    total_cost = sum(layer_cost)
    hi = total_cost * max(device_time)  # everything on the slowest device
    lower_bound = integral_lower_bound(table, hi)

    # Class-collapse exact path: few distinct device speeds (the headline
    # instances' integer slowdown draws) turn the 2^D subset DP into a
    # count-vector DP — exact in seconds where the anneal certified
    # 2-6% gaps, and its relaxed solve tightens the bound either way.
    class_solution = None
    if use_native and D > native_exact_limit:
        class_solution, class_bound = _solve_by_classes(
            layer_cost, layer_mem, device_time, device_mem, tolerance
        )
        if class_bound is not None:
            lower_bound = max(lower_bound, class_bound)
        if class_solution is not None:
            c_order, c_slices, c_bottleneck = class_solution
            if (
                lower_bound > 0
                and c_bottleneck / lower_bound - 1.0
                <= max(gap_target, tolerance)
            ):
                return PartitionResult(
                    c_order, [list(s) for s in c_slices], c_bottleneck,
                    lower_bound=lower_bound, path="native_classes",
                )

    if use_native and D <= native_exact_limit:
        from . import native

        solved = native.solve_minmax_native(
            layer_cost, layer_mem, device_time, device_mem,
            tolerance=tolerance,
        )
        if solved is not None:
            order, slices, bottleneck = solved
            return PartitionResult(order, slices, bottleneck,
                                   lower_bound=lower_bound,
                                   path="native_exact")

    if use_native and D > native_exact_limit:
        # Native anneal: same order-search as the Python fallback below at
        # ~10^4 x the evaluation rate, so the anneal budget that certifies
        # gap ~0.05 in Python typically reaches the gap target here.
        from . import native

        # anneal_seconds<=0 / anneal_evals<=0 means "no annealing" on the
        # Python path too — the native call then runs only the initial
        # sorted-order score + boundary polish (milliseconds)
        anneal_on = anneal_seconds > 0 and anneal_evals > 0
        try:
            solved = native.solve_large_native(
                layer_cost, layer_mem, device_time, device_mem,
                seed=seed,
                rounds=max(anneal_rounds, 1) if anneal_on else 0,
                evals0=max(anneal_evals * 20, 20000),
                wall_cap_s=anneal_seconds if anneal_on else 0.0,
                lower_bound=lower_bound,
                gap_target=gap_target,
                tolerance=tolerance,
            )
        except RuntimeError:
            # the native feasibility probe (sorted order + random
            # restarts, greedy walk) is weaker than the Python
            # _feasible_greedy's max-coverage device selection on
            # fragmented-memory instances — fall through rather than
            # declare a solvable instance infeasible; the Python path
            # raises its own error if it truly cannot cover the model
            solved = None
        if solved is not None:
            order, slices, bottleneck = solved
            # The native core's in-anneal polish is single-layer adjacent
            # shifts only; the Python local search adds 2/4-layer block
            # moves and bottleneck-device position swaps — complementary
            # neighborhoods that cost milliseconds and routinely shave
            # the last fraction of a percent off the certified gap.
            order, slices = _local_search(
                table, order, [tuple(s) for s in slices]
            )
            achieved = _bottleneck(table, order, slices)
            path = "native_anneal"
            if (
                class_solution is not None
                and class_solution[2] < achieved
            ):
                order, slices, achieved = class_solution
                path = "native_classes"
            return PartitionResult(order, [list(s) for s in slices],
                                   achieved, lower_bound=lower_bound,
                                   path=path)

    rng = random.Random(seed)

    def feasible(T: float):
        if D <= exact_limit:
            return _feasible_exact(table, T)
        return _feasible_greedy(table, T, rng, attempts=greedy_attempts)

    best = feasible(hi)
    if best is None:
        raise RuntimeError(
            "allocation infeasible: memory capacities cannot hold the model "
            f"(layers={L}, devices={D})"
        )

    # Binary search down to relative tolerance, floored at the certified
    # bound — nothing below it is feasible, integrally or otherwise.
    lo = lower_bound
    for _ in range(60):
        if hi - lo <= tolerance * max(hi, 1e-30):
            break
        mid = (lo + hi) / 2.0
        sol = feasible(mid)
        if sol is not None:
            best, hi = sol, mid
        else:
            lo = mid

    order, slices = best
    if D > exact_limit:
        # greedy solutions deserve a polish: boundary moves + device swaps
        order, slices = _local_search(table, order, slices)
        achieved = _bottleneck(table, order, slices)
        # Escalating anneal: rounds of DOUBLING evaluation budgets while the
        # certified gap stays above ``gap_target``.  Each round's budget is
        # pure eval-count, so a round is deterministic per seed regardless
        # of machine speed; ``anneal_seconds`` — a generous
        # wall cap in the spirit of the reference's 300 s MIP limit
        # (``scaelum/dynamics/allocator.py:109-132``) — is checked only at
        # round BOUNDARIES, so it can skip later rounds on a slow machine
        # but never truncates a round mid-flight.
        if anneal_seconds > 0 and anneal_evals > 0:
            # `clock` is injectable: the wall cap is the
            # ONLY wall-clock read in this module, and tests pin it to a
            # fake to exercise the round-boundary skip deterministically
            deadline = clock() + anneal_seconds
            evals = anneal_evals
            for _ in range(anneal_rounds):
                if lower_bound > 0:
                    gap = achieved / lower_bound - 1.0
                else:
                    gap = float("inf")
                if gap <= max(gap_target, tolerance):
                    break
                if clock() > deadline:
                    break
                annealed = _anneal_orders(
                    table, order, lower_bound, rng, achieved,
                    max_evals=evals,
                )
                if annealed is not None:
                    a_order, a_slices = annealed
                    a_order, a_slices = _local_search(
                        table, a_order, a_slices
                    )
                    if _bottleneck(table, a_order, a_slices) < achieved:
                        order, slices = a_order, list(a_slices)
                        achieved = _bottleneck(table, order, slices)
                evals *= 2
    achieved = _bottleneck(table, order, slices)
    path = "python_exact" if D <= exact_limit else "python_greedy"
    if class_solution is not None and class_solution[2] < achieved:
        order, slices, achieved = class_solution
        slices = list(slices)
        path = "native_classes"
    return PartitionResult(order, slices, achieved, lower_bound=lower_bound,
                           path=path)


def _bottleneck(table: _CoverTable, order, slices) -> float:
    worst = 0.0
    for d, (s, e) in zip(order, slices):
        worst = max(
            worst,
            table.device_time[d]
            * (table.cost_prefix[e] - table.cost_prefix[s]),
        )
    return worst


def _local_search(table: _CoverTable, order, slices, max_rounds: int = 200):
    """Hill-climb on the greedy assignment: shift slice boundaries by one
    layer and swap device positions while the bottleneck improves.

    The exact DP path doesn't need this; the randomized greedy for large
    clusters leaves a few percent on the table that these two moves — the
    classic neighborhood for contiguous-partition scheduling — recover.
    """
    order = list(order)
    slices = [list(s) for s in slices]

    def stage_time(i) -> float:
        d = order[i]
        s, e = slices[i]
        return table.device_time[d] * (
            table.cost_prefix[e] - table.cost_prefix[s]
        )

    def mem_ok(i) -> bool:
        s, e = slices[i]
        return (
            table.mem_prefix[e] - table.mem_prefix[s]
            <= table.device_mem[order[i]] + 1e-9
        )

    n = len(order)
    for _ in range(max_rounds):
        times = [stage_time(i) for i in range(n)]
        worst = max(range(n), key=lambda i: times[i])
        current = times[worst]
        improved = False

        # move a block of 1..4 boundary layers off the bottleneck stage to
        # a neighbor (single-layer shifts stall on profiles where one unit
        # is much cheaper than the imbalance)
        for nb, take_from in ((worst - 1, "left"), (worst + 1, "right")):
            if not (0 <= nb < n) or improved:
                continue
            for k in (4, 2, 1):
                s, e = slices[worst]
                if e - s <= k:
                    continue
                old_worst, old_nb = list(slices[worst]), list(slices[nb])
                if take_from == "left" and nb == worst - 1:
                    slices[worst][0] += k
                    slices[nb][1] += k
                elif take_from == "right" and nb == worst + 1:
                    slices[worst][1] -= k
                    slices[nb][0] -= k
                else:  # pragma: no cover
                    continue
                if (
                    mem_ok(worst)
                    and mem_ok(nb)
                    and max(stage_time(worst), stage_time(nb))
                    < current - 1e-15
                ):
                    improved = True
                    break
                slices[worst], slices[nb] = old_worst, old_nb

        if improved:
            continue

        # swap the bottleneck device with any other position
        for j in range(n):
            if j == worst:
                continue
            order[worst], order[j] = order[j], order[worst]
            if (
                mem_ok(worst)
                and mem_ok(j)
                and max(stage_time(worst), stage_time(j)) < current - 1e-15
            ):
                improved = True
                break
            order[worst], order[j] = order[j], order[worst]

        if not improved:
            break

    return order, [tuple(s) for s in slices]


# --------------------------------------------------------------------------
# mesh-shape search (the mesh-native engine's allocator)
# --------------------------------------------------------------------------


@dataclass
class MeshShapeResult:
    """A mesh operating point: contiguous layer slices + chips per stage
    over ONE homogeneous device order.

    ``slices[i] = (start, end)`` half-open layer range of pipeline stage
    i; ``chips[i]`` how many contiguous devices its sub-mesh owns
    (``sum(chips) <= num_devices`` — the search may leave chips unused
    when ``max_chips_per_stage`` caps useful parallelism).
    ``bottleneck`` is the scored objective ``max_i stage_costs[i] /
    chips[i] + stage_overhead * num_stages``.
    """

    slices: List[Tuple[int, int]]
    chips: List[int]
    stage_costs: List[float]
    bottleneck: float
    num_devices: int
    stage_overhead: float = 0.0

    @property
    def num_stages(self) -> int:
        return len(self.slices)


def _balanced_contiguous(
    layer_cost: Sequence[float], max_slices: int
) -> List[Tuple[int, int]]:
    """Min-max contiguous partition of ``layer_cost`` into at most
    ``max_slices`` slices over UNIT-speed slots: binary search on the
    bottleneck T with a greedy maximal cover (optimal for a fixed order
    of identical devices, same argument as ``_fixed_order_walk``)."""
    prefix = _prefix(layer_cost)
    L = len(layer_cost)

    def cover(T: float) -> Optional[List[Tuple[int, int]]]:
        slices: List[Tuple[int, int]] = []
        pos = 0
        while pos < L and len(slices) < max_slices:
            end = bisect.bisect_right(prefix, prefix[pos] + T + 1e-12) - 1
            if end <= pos:
                return None  # one layer alone exceeds T
            slices.append((pos, end))
            pos = end
        return slices if pos >= L else None

    lo = max(layer_cost) if layer_cost else 0.0
    hi = prefix[L]
    best = cover(hi)
    if best is None:  # pragma: no cover - hi always covers
        raise RuntimeError("balanced partition failed at the total cost")
    for _ in range(60):
        if hi - lo <= 1e-12 * max(hi, 1.0):
            break
        mid = (lo + hi) / 2.0
        cand = cover(mid)
        if cand is not None:
            best, hi = cand, mid
        else:
            lo = mid
    return best


def _greedy_chips(
    stage_costs: Sequence[float], num_devices: int,
    max_chips_per_stage: Optional[int] = None,
) -> List[int]:
    """Integer chips minimizing ``max_i cost_i / chips_i`` with
    ``sum(chips) <= num_devices`` and 1 <= chips_i <= cap.

    Start at one chip per stage and repeatedly give the next chip to the
    current bottleneck stage — optimal because cost/k is convex
    decreasing in k (the classic discrete resource-allocation exchange
    argument).  Chips beyond every stage's cap stay unspent.
    """
    S = len(stage_costs)
    if num_devices < S:
        raise ValueError(
            f"{S} stages need at least {S} devices, have {num_devices}"
        )
    cap = max_chips_per_stage if max_chips_per_stage else num_devices
    chips = [1] * S
    heap = [(-float(c), i) for i, c in enumerate(stage_costs)]
    heapq.heapify(heap)
    spare = num_devices - S
    while spare > 0 and heap:
        _, i = heapq.heappop(heap)
        if chips[i] >= cap:
            continue  # capped stage leaves the pool
        chips[i] += 1
        spare -= 1
        heapq.heappush(heap, (-float(stage_costs[i]) / chips[i], i))
    return chips


def solve_mesh_shapes(
    layer_cost: Sequence[float],
    num_devices: int,
    layer_mem: Optional[Sequence[float]] = None,
    mem_per_chip: Optional[float] = None,
    max_stages: Optional[int] = None,
    max_chips_per_stage: Optional[int] = None,
    stage_overhead: float = 0.0,
) -> MeshShapeResult:
    """Mesh-shape search: extend the contiguous min-max solve to choose
    BOTH the stage partition and chips-per-stage.

    For each candidate stage count S the layers get the balanced
    contiguous partition (sub-mesh chips are same-speed by construction,
    so unit devices), then ``num_devices`` chips spread greedily so
    per-stage time/chip balances (PipeDream's partitioner loop with the
    profiler's costs).  The score charges ``stage_overhead`` — the
    per-stage host dispatch cost per microbatch tick — so the search trades
    intra-stage data parallelism against issue-loop length; at overhead
    0 ties break toward FEWER stages (ascending S, strict improvement).

    Constraints: ``mem_per_chip`` bounds each stage's slice memory
    (parameters replicate over the stage's sub-mesh, so every chip holds
    its stage's full slice); ``max_chips_per_stage`` bounds useful
    intra-stage parallelism (dp cannot exceed the microbatch rows).
    """
    L = len(layer_cost)
    if L == 0:
        return MeshShapeResult([], [], [], 0.0, int(num_devices),
                               float(stage_overhead))
    if num_devices < 1:
        raise ValueError("no devices")
    if layer_mem is not None and len(layer_mem) != L:
        raise ValueError(
            f"{len(layer_mem)} layer_mem entries for {L} layers"
        )
    prefix = _prefix(layer_cost)
    mem_prefix = _prefix(layer_mem) if layer_mem is not None else None
    S_hi = min(int(num_devices), L, max_stages or int(num_devices))
    best: Optional[MeshShapeResult] = None
    for S in range(1, S_hi + 1):
        slices = _balanced_contiguous(layer_cost, S)
        if mem_prefix is not None and mem_per_chip is not None:
            if any(
                mem_prefix[e] - mem_prefix[s] > mem_per_chip + 1e-9
                for s, e in slices
            ):
                continue  # a slice no single chip can hold
        costs = [prefix[e] - prefix[s] for s, e in slices]
        chips = _greedy_chips(
            costs, int(num_devices), max_chips_per_stage
        )
        score = max(
            c / k for c, k in zip(costs, chips)
        ) + float(stage_overhead) * len(slices)
        if best is None or score < best.bottleneck - 1e-15:
            best = MeshShapeResult(
                slices=[tuple(s) for s in slices],
                chips=chips,
                stage_costs=costs,
                bottleneck=score,
                num_devices=int(num_devices),
                stage_overhead=float(stage_overhead),
            )
    if best is None:
        raise RuntimeError(
            "mesh-shape search infeasible: no stage count fits every "
            f"slice under mem_per_chip={mem_per_chip} (layers={L}, "
            f"devices={num_devices}) — parameters replicate over a "
            "stage's sub-mesh, so a slice must fit one chip"
        )
    return best


__all__ = [
    "solve_contiguous_minmax",
    "PartitionResult",
    "MeshShapeResult",
    "solve_mesh_shapes",
    "integral_lower_bound",
]
