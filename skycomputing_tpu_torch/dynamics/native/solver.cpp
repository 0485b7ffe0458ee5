// Exact contiguous layer->device partition solver (native core).
//
// The port's own copy of skycomputing_tpu/dynamics/native/solver.cpp, host
// code that is independent of the accelerator.  The reference obtains
// native solving power by shelling out to the CBC MIP solver through pulp
// (scaelum/dynamics/allocator.py:109-132); this is its native equivalent:
// the same optimization problem
// — partition a layer sequence into contiguous slices on distinct devices,
// free device order, per-device memory capacity, minimize the bottleneck
// max_d device_time[d] * sum(layer_cost[slice_d]) — solved exactly by
// binary search over the bottleneck T with a subset-DP feasibility check
// (frontier[mask] = furthest layer reachable using device set `mask`;
// dominance is valid because reachability is monotone in the start index).
//
// Complexity per feasibility probe: O(2^D * D * log L).  In native code the
// exact regime extends to ~22 devices (the pure-Python DP in solver.py caps
// at 12); beyond that the Python greedy takes over.
//
// C ABI, consumed via ctypes (no pybind11 in the image).

#include <algorithm>
#include <chrono>
#include <random>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// furthest layer index reachable from `start` on device `d` under budget T
int cover(int start, int d, double T, int L,
          const std::vector<double>& cost_prefix,
          const std::vector<double>& mem_prefix,
          const double* device_time, const double* device_mem) {
  if (start >= L) return L;
  const double dt = device_time[d];
  const double cost_budget =
      dt > 0 ? T / dt : std::numeric_limits<double>::infinity();

  // binary search: largest r with cost_prefix[r] <= cost_prefix[start]+budget
  auto search = [&](const std::vector<double>& prefix, double budget) {
    const double limit = prefix[start] + budget + 1e-12;
    int lo = start, hi = L;  // invariant: prefix[lo] <= limit
    while (lo < hi) {
      int mid = (lo + hi + 1) / 2;
      if (prefix[mid] <= limit) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  };

  const int r_cost = search(cost_prefix, cost_budget);
  const int r_mem = search(mem_prefix, device_mem[d] + 1e-9);
  const int r = r_cost < r_mem ? r_cost : r_mem;
  return r > start ? r : start;
}

// subset DP; fills order/slices on success, returns used-device count or -1
int feasible(double T, int L, int D,
             const std::vector<double>& cost_prefix,
             const std::vector<double>& mem_prefix,
             const double* device_time, const double* device_mem,
             std::vector<int>& frontier, std::vector<int>& choice,
             int* out_order, int* out_starts, int* out_ends) {
  const std::size_t size = std::size_t(1) << D;
  frontier.assign(size, 0);
  choice.assign(size, -1);

  std::size_t full = 0;
  for (std::size_t mask = 1; mask < size; ++mask) {
    int best = 0, best_d = -1;
    std::size_t m = mask;
    while (m) {
      const std::size_t low = m & (~m + 1);
      const int d = __builtin_ctzll(low);
      m ^= low;
      const int prev = frontier[mask ^ low];
      const int reach =
          cover(prev, d, T, L, cost_prefix, mem_prefix, device_time,
                device_mem);
      if (best_d == -1 || reach > best) {
        best = reach;
        best_d = d;
      }
    }
    frontier[mask] = best;
    choice[mask] = best_d;
    if (best >= L) {
      full = mask;
      break;
    }
  }
  if (full == 0) return -1;

  // peel choices: device order along the pipeline is the reverse of peeling
  std::vector<int> order_rev;
  std::size_t mask = full;
  while (mask) {
    const int d = choice[mask];
    order_rev.push_back(d);
    mask ^= std::size_t(1) << d;
  }

  int used = 0, pos = 0;
  for (auto it = order_rev.rbegin(); it != order_rev.rend(); ++it) {
    const int d = *it;
    const int end = cover(pos, d, T, L, cost_prefix, mem_prefix, device_time,
                          device_mem);
    if (end > pos) {
      out_order[used] = d;
      out_starts[used] = pos;
      out_ends[used] = end;
      ++used;
    }
    pos = end;
  }
  return pos >= L ? used : -1;
}

}  // namespace

// ---------------------------------------------------------------------------
// Large-D solver: the exact subset-DP above is exponential in D, so beyond
// ~22 devices the Python side falls back to a randomized greedy plus a
// Python-loop simulated anneal over device orders — ~7 ms per order
// evaluation, which starves the anneal on a 1-core host (the r05 headline
// instance certified gaps of 0.02-0.06 at an 80 s cap).  This native
// version runs the same search — score an order by bisecting the minimum
// bottleneck its fixed-order walk can achieve, anneal over orders with
// swap/move/bottleneck-targeted proposals, polish with boundary moves —
// at roughly 50-150 us per evaluation, turning the same wall budget into
// orders of magnitude more search effort.  Determinism: fixed eval-count
// rounds from a seeded mt19937 — bit-identical per seed whenever the
// eval budget completes inside the wall cap (the regime the tests pin);
// under a binding cap an in-round check truncates with ~0.5 s overshoot.

namespace {

struct Walked {
  std::vector<int> starts, ends;  // per position in order; start==end: empty
  bool complete = false;
};

// greedy maximal walk of `order` under budget T
void walk_order_into(const std::vector<int>& order, double T, int L,
                     const std::vector<double>& cost_prefix,
                     const std::vector<double>& mem_prefix,
                     const double* device_time, const double* device_mem,
                     Walked& w) {
  const int D = int(order.size());
  w.starts.resize(D);
  w.ends.resize(D);
  int pos = 0;
  for (int i = 0; i < D; ++i) {
    const int end = cover(pos, order[i], T, L, cost_prefix, mem_prefix,
                          device_time, device_mem);
    w.starts[i] = pos;
    w.ends[i] = end;
    pos = end;
  }
  w.complete = pos >= L;
}

// minimum bottleneck achievable by `order` (bisection over T); +inf when
// even an unbounded compute budget cannot cover L (memory-capped order)
double order_opt(const std::vector<int>& order, double lo, double hi,
                 double tolerance, int iters, int L,
                 const std::vector<double>& cost_prefix,
                 const std::vector<double>& mem_prefix,
                 const double* device_time, const double* device_mem,
                 Walked* out = nullptr) {
  thread_local Walked scratch;
  walk_order_into(order, hi, L, cost_prefix, mem_prefix, device_time,
                  device_mem, scratch);
  if (!scratch.complete) return std::numeric_limits<double>::infinity();
  double best = hi;
  if (out) *out = scratch;
  for (int it = 0; it < iters; ++it) {
    if (hi - lo <= tolerance * (hi > 1e-30 ? hi : 1e-30)) break;
    const double mid = 0.5 * (lo + hi);
    walk_order_into(order, mid, L, cost_prefix, mem_prefix, device_time,
                    device_mem, scratch);
    if (scratch.complete) {
      best = mid;
      hi = mid;
      if (out) *out = scratch;
    } else {
      lo = mid;
    }
  }
  return best;
}

double realized_bottleneck(const std::vector<int>& order, const Walked& w,
                           const std::vector<double>& cost_prefix,
                           const double* device_time) {
  double worst = 0.0;
  for (std::size_t i = 0; i < order.size(); ++i)
    worst = std::max(worst, device_time[order[i]] *
                                (cost_prefix[w.ends[i]] -
                                 cost_prefix[w.starts[i]]));
  return worst;
}

// hill-climb on slice boundaries: shift one layer between adjacent
// non-empty slices while the realized bottleneck improves
void boundary_polish(const std::vector<int>& order, Walked& w, int L,
                     const std::vector<double>& cost_prefix,
                     const std::vector<double>& mem_prefix,
                     const double* device_time, const double* device_mem,
                     int max_rounds = 200) {
  const int D = int(order.size());
  auto stage_time = [&](int i) {
    return device_time[order[i]] *
           (cost_prefix[w.ends[i]] - cost_prefix[w.starts[i]]);
  };
  auto mem_of = [&](int i) {
    return mem_prefix[w.ends[i]] - mem_prefix[w.starts[i]];
  };
  for (int round = 0; round < max_rounds; ++round) {
    bool moved = false;
    for (int i = 0; i + 1 < D; ++i) {
      if (w.ends[i] <= w.starts[i]) continue;
      int j = i + 1;
      while (j < D && w.ends[j] <= w.starts[j]) ++j;  // next non-empty
      if (j >= D) break;
      const double ti = stage_time(i), tj = stage_time(j);
      // move i's last layer to j
      if (ti > tj && w.ends[i] - w.starts[i] > 1) {
        const int layer = w.ends[i] - 1;
        const double lm = mem_prefix[layer + 1] - mem_prefix[layer];
        if (mem_of(j) + lm <= device_mem[order[j]] + 1e-9) {
          const double ni =
              device_time[order[i]] *
              (cost_prefix[layer] - cost_prefix[w.starts[i]]);
          const double nj =
              device_time[order[j]] *
              (cost_prefix[w.ends[j]] - cost_prefix[layer]);
          if (std::max(ni, nj) < std::max(ti, tj) - 1e-15) {
            --w.ends[i];
            w.starts[j] = layer;
            // intermediate empty stages must track the boundary
            for (int k = i + 1; k < j; ++k) w.starts[k] = w.ends[k] = layer;
            moved = true;
          }
        }
      } else if (tj > ti && w.ends[j] - w.starts[j] > 1) {
        // move j's first layer to i
        const int layer = w.starts[j];
        const double lm = mem_prefix[layer + 1] - mem_prefix[layer];
        if (mem_of(i) + lm <= device_mem[order[i]] + 1e-9) {
          const double ni =
              device_time[order[i]] *
              (cost_prefix[layer + 1] - cost_prefix[w.starts[i]]);
          const double nj =
              device_time[order[j]] *
              (cost_prefix[w.ends[j]] - cost_prefix[layer + 1]);
          if (std::max(ni, nj) < std::max(ti, tj) - 1e-15) {
            w.ends[i] = layer + 1;
            w.starts[j] = layer + 1;
            for (int k = i + 1; k < j; ++k)
              w.starts[k] = w.ends[k] = layer + 1;
            moved = true;
          }
        }
      }
    }
    if (!moved) break;
  }
}

}  // namespace

extern "C" {

// Anneal-based large-D solve.  Returns used-device count (>0), -1 when no
// explored order covers the model (infeasible), -2 on bad sizes.
int skytpu_solve_large(int L, int D, const double* layer_cost,
                       const double* layer_mem, const double* device_time,
                       const double* device_mem, unsigned long long seed,
                       int rounds, long evals0, double wall_cap_s,
                       double lower_bound, double gap_target,
                       double tolerance, int* out_order, int* out_starts,
                       int* out_ends, double* out_bottleneck) {
  if (L <= 0 || D <= 0 || L > 1000000 || D > 100000) return -2;

  std::vector<double> cost_prefix(L + 1, 0.0), mem_prefix(L + 1, 0.0);
  double total_cost = 0.0, max_dt = 0.0;
  for (int i = 0; i < L; ++i) {
    cost_prefix[i + 1] = cost_prefix[i] + layer_cost[i];
    mem_prefix[i + 1] = mem_prefix[i] + layer_mem[i];
    total_cost += layer_cost[i];
  }
  for (int d = 0; d < D; ++d) max_dt = std::max(max_dt, device_time[d]);
  const double hi0 = total_cost * max_dt;

  // initial order: fastest devices first (they should sit where layers
  // remain), ties by index for determinism
  std::vector<int> order(D);
  for (int d = 0; d < D; ++d) order[d] = d;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    if (device_time[a] != device_time[b])
      return device_time[a] < device_time[b];
    return a < b;
  });

  const int score_iters = 22;
  auto score = [&](const std::vector<int>& o, Walked* w = nullptr) {
    return order_opt(o, std::max(lower_bound, 0.0), hi0, tolerance,
                     score_iters, L, cost_prefix, mem_prefix, device_time,
                     device_mem, w);
  };

  Walked best_w;
  double best = score(order, &best_w);
  std::vector<int> best_order = order;
  if (std::isinf(best)) {
    // try a few random restarts before declaring infeasible
    std::mt19937_64 rng(seed ^ 0x9e3779b97f4a7c15ULL);
    for (int attempt = 0; attempt < 64 && std::isinf(best); ++attempt) {
      std::shuffle(order.begin(), order.end(), rng);
      best = score(order, &best_w);
      if (!std::isinf(best)) best_order = order;
    }
    if (std::isinf(best)) return -1;
  }
  boundary_polish(best_order, best_w, L, cost_prefix, mem_prefix, device_time,
                  device_mem);
  best = realized_bottleneck(best_order, best_w, cost_prefix, device_time);

  std::mt19937_64 rng(seed);
  const auto t_start = std::chrono::steady_clock::now();
  auto elapsed_s = [&] {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                         t_start)
        .count();
  };

  long evals = evals0 > 0 ? evals0 : 20000;
  std::vector<int> cur_order = best_order;
  Walked cur_w;
  double cur = score(cur_order, &cur_w);
  std::vector<int> cand;
  for (int r = 0; r < rounds; ++r) {
    const double gap =
        lower_bound > 0 ? best / lower_bound - 1.0
                        : std::numeric_limits<double>::infinity();
    if (gap <= gap_target || elapsed_s() > wall_cap_s) break;
    // geometric temperature decay across rounds; relative scale
    const double temp0 = 0.02 * best / (1 << r);
    bool out_of_time = false;
    for (long e = 0; e < evals; ++e) {
      // bounded overshoot: rounds double geometrically, so a
      // boundary-only wall check could overrun the cap by the whole
      // last round; checking every 4096 evals caps the overrun at
      // ~0.5 s.  (Truncation point then depends on machine speed —
      // per-seed determinism holds whenever the eval budget finishes
      // inside the cap, which is how the tests pin it.)
      if ((e & 4095) == 4095 && elapsed_s() > wall_cap_s) {
        out_of_time = true;
        break;
      }
      cand = cur_order;
      const int kind = int(rng() % 3);
      if (kind == 0) {
        const int i = int(rng() % D), j = int(rng() % D);
        std::swap(cand[i], cand[j]);
      } else if (kind == 1) {
        const int i = int(rng() % D), j = int(rng() % D);
        const int d = cand[i];
        cand.erase(cand.begin() + i);
        cand.insert(cand.begin() + j, d);
      } else {
        // bottleneck-targeted: swap the CACHED bottleneck position of the
        // current order with a random other position
        int bpos = 0;
        double worst = -1.0;
        for (int i = 0; i < D; ++i) {
          const double t = device_time[cur_order[i]] *
                           (cost_prefix[cur_w.ends[i]] -
                            cost_prefix[cur_w.starts[i]]);
          if (t > worst) {
            worst = t;
            bpos = i;
          }
        }
        const int j = int(rng() % D);
        std::swap(cand[bpos], cand[j]);
      }
      Walked w;
      const double s = score(cand, &w);
      if (std::isinf(s)) continue;
      const double temp = temp0 > 1e-300 ? temp0 : 1e-300;
      if (s < cur ||
          std::generate_canonical<double, 53>(rng) <
              std::exp(-(s - cur) / temp)) {
        cur_order = cand;
        cur = s;
        cur_w = w;
        if (s < best) {
          boundary_polish(cand, w, L, cost_prefix, mem_prefix, device_time,
                          device_mem);
          const double polished =
              realized_bottleneck(cand, w, cost_prefix, device_time);
          if (polished < best) {
            best = polished;
            best_order = cand;
            best_w = w;
          }
        }
      }
    }
    if (out_of_time) break;
    evals *= 2;
  }

  int used = 0;
  for (int i = 0; i < D; ++i) {
    if (best_w.ends[i] > best_w.starts[i]) {
      out_order[used] = best_order[i];
      out_starts[used] = best_w.starts[i];
      out_ends[used] = best_w.ends[i];
      ++used;
    }
  }
  *out_bottleneck = best;
  return used > 0 ? used : -1;
}

}  // extern "C"

extern "C" {

// Returns the number of used devices (>0) on success, -1 if infeasible.
// out_order/out_starts/out_ends must have room for D entries.
int skytpu_solve_minmax(int L, int D, const double* layer_cost,
                        const double* layer_mem, const double* device_time,
                        const double* device_mem, double tolerance,
                        int max_iters, int* out_order, int* out_starts,
                        int* out_ends, double* out_bottleneck) {
  if (L <= 0 || D <= 0 || D > 30) return -2;

  std::vector<double> cost_prefix(L + 1, 0.0), mem_prefix(L + 1, 0.0);
  double total_cost = 0.0, max_dt = 0.0;
  for (int i = 0; i < L; ++i) {
    cost_prefix[i + 1] = cost_prefix[i] + layer_cost[i];
    mem_prefix[i + 1] = mem_prefix[i] + layer_mem[i];
    total_cost += layer_cost[i];
  }
  for (int d = 0; d < D; ++d) max_dt = std::max(max_dt, device_time[d]);

  std::vector<int> frontier, choice;
  std::vector<int> best_order(D), best_starts(D), best_ends(D);

  double hi = total_cost * max_dt;
  double lo = 0.0;

  int best_used =
      feasible(hi, L, D, cost_prefix, mem_prefix, device_time, device_mem,
               frontier, choice, best_order.data(), best_starts.data(),
               best_ends.data());
  if (best_used < 0) return -1;

  for (int it = 0; it < max_iters; ++it) {
    if (hi - lo <= tolerance * (hi > 1e-30 ? hi : 1e-30)) break;
    const double mid = 0.5 * (lo + hi);
    std::vector<int> order(D), starts(D), ends(D);
    const int used =
        feasible(mid, L, D, cost_prefix, mem_prefix, device_time, device_mem,
                 frontier, choice, order.data(), starts.data(), ends.data());
    if (used > 0) {
      best_used = used;
      best_order = order;
      best_starts = starts;
      best_ends = ends;
      hi = mid;
    } else {
      lo = mid;
    }
  }

  double achieved = 0.0;
  for (int i = 0; i < best_used; ++i) {
    const int d = best_order[i];
    const double t =
        device_time[d] *
        (cost_prefix[best_ends[i]] - cost_prefix[best_starts[i]]);
    achieved = std::max(achieved, t);
    out_order[i] = d;
    out_starts[i] = best_starts[i];
    out_ends[i] = best_ends[i];
  }
  *out_bottleneck = achieved;
  return best_used;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Class-collapse exact solver.  The headline instances' 64 devices carry
// only ~6 distinct slowdowns (the reference experiment draws integers in
// [1, 7)), so the 2^64 subset DP collapses to a count-vector DP: a state
// is "how many devices of each class are already used", the value is the
// max-frontier layer index (the same dominance argument as the subset DP
// — cover() is monotone in its start index).  State count is
// prod_k(count_k + 1): ~2.3M for the seed-35 draw, exact in seconds where
// the order-anneal certified gaps of 0.02-0.06.
//
// Memory heterogeneity inside a class is handled by the CALLER solving
// twice: once with each class's minimum member memory (any produced slice
// fits every member -> a real, feasible partition: an upper bound) and
// once with the maximum (a relaxation -> a certified lower bound).  With
// slack memory the two coincide and the result is provably optimal.

namespace {

// per-probe cover table: reach[k][p] = furthest layer from p on class k
void fill_cover(double T, int L, int K, const std::vector<double>& cost_prefix,
                const std::vector<double>& mem_prefix, const double* class_dt,
                const double* class_mem, std::vector<int>& reach) {
  for (int k = 0; k < K; ++k) {
    const double dt = class_dt[k];
    const double cost_budget =
        dt > 0 ? T / dt : std::numeric_limits<double>::infinity();
    int* row = reach.data() + std::size_t(k) * (L + 1);
    for (int p = 0; p <= L; ++p) {
      const double climit = cost_prefix[p] + cost_budget + 1e-12;
      const double mlimit = mem_prefix[p] + class_mem[k] + 1e-9;
      int lo = p, hi = L;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (cost_prefix[mid] <= climit && mem_prefix[mid] <= mlimit) lo = mid;
        else hi = mid - 1;
      }
      row[p] = lo;
    }
  }
}

}  // namespace

extern "C" {

// Exact solve over device classes.  counts[k] devices of class k share
// slowdown class_dt[k] and memory class_mem[k].  On success returns the
// number of slices (>0); out_class[i] is the CLASS of pipeline slice i.
// -1: infeasible even at the trivial threshold.  -2: size guard tripped
// (caller falls back to the anneal path).
int skytpu_solve_classes(int L, int K, const double* layer_cost,
                         const double* layer_mem, const int* counts,
                         const double* class_dt, const double* class_mem,
                         double tolerance, int max_iters,
                         long long max_states, int* out_class,
                         int* out_starts, int* out_ends,
                         double* out_bottleneck) {
  if (L <= 0 || K <= 0 || K > 12 || L > 1000000) return -2;

  long long n_states = 1;
  for (int k = 0; k < K; ++k) {
    if (counts[k] <= 0) return -2;
    n_states *= counts[k] + 1;
    if (n_states > max_states) return -2;
  }

  std::vector<double> cost_prefix(L + 1, 0.0), mem_prefix(L + 1, 0.0);
  double total_cost = 0.0, max_dt = 0.0;
  for (int i = 0; i < L; ++i) {
    cost_prefix[i + 1] = cost_prefix[i] + layer_cost[i];
    mem_prefix[i + 1] = mem_prefix[i] + layer_mem[i];
    total_cost += layer_cost[i];
  }
  for (int k = 0; k < K; ++k) max_dt = std::max(max_dt, class_dt[k]);

  std::vector<long long> stride(K);
  long long acc = 1;
  for (int k = 0; k < K; ++k) {
    stride[k] = acc;
    acc *= counts[k] + 1;
  }

  std::vector<int> reach(std::size_t(K) * (L + 1));
  std::vector<int> frontier(n_states);
  std::vector<int8_t> choice(n_states);
  std::vector<int> digits(K);

  // feasibility probe: forward count-vector DP (predecessor s - stride[k]
  // always precedes s in flat order); fills choice[] for reconstruction
  // and returns the reaching state, or -1
  auto probe = [&](double T) -> long long {
    fill_cover(T, L, K, cost_prefix, mem_prefix, class_dt, class_mem, reach);
    std::fill(frontier.begin(), frontier.end(), -1);
    frontier[0] = 0;
    std::fill(digits.begin(), digits.end(), 0);
    for (long long s = 1; s < n_states; ++s) {
      // odometer increment of the mixed-radix digits
      for (int k = 0; k < K; ++k) {
        if (++digits[k] <= counts[k]) break;
        digits[k] = 0;
      }
      int best = -1;
      int8_t best_k = -1;
      for (int k = 0; k < K; ++k) {
        if (digits[k] == 0) continue;
        const int prev = frontier[s - stride[k]];
        if (prev < 0) continue;
        const int r = reach[std::size_t(k) * (L + 1) + prev];
        if (r > best) {
          best = r;
          best_k = int8_t(k);
        }
      }
      frontier[s] = best;
      choice[s] = best_k;
      if (best >= L) return s;
    }
    return -1;
  };

  double hi = total_cost * max_dt, lo = 0.0;
  long long full = probe(hi);
  if (full < 0) return -1;
  double best_T = hi;
  for (int it = 0; it < max_iters; ++it) {
    if (hi - lo <= tolerance * (hi > 1e-30 ? hi : 1e-30)) break;
    const double mid = 0.5 * (lo + hi);
    const long long got = probe(mid);
    if (got >= 0) {
      full = got;
      best_T = mid;
      hi = mid;
    } else {
      lo = mid;
    }
  }

  // re-probe at the accepted threshold so choice[] matches, then peel
  full = probe(best_T);
  if (full < 0) return -1;  // cannot happen: best_T was feasible
  std::vector<int> class_rev;
  long long s = full;
  while (s != 0) {
    const int k = choice[s];
    if (k < 0) return -1;  // unreachable state in a peeled chain
    class_rev.push_back(k);
    s -= stride[k];
  }

  int used = 0, pos = 0;
  double achieved = 0.0;
  for (auto it = class_rev.rbegin(); it != class_rev.rend(); ++it) {
    const int k = *it;
    const int end = reach[std::size_t(k) * (L + 1) + pos];
    if (end > pos) {
      out_class[used] = k;
      out_starts[used] = pos;
      out_ends[used] = end;
      achieved = std::max(achieved,
                          class_dt[k] * (cost_prefix[end] - cost_prefix[pos]));
      ++used;
    }
    pos = end;
  }
  if (pos < L) return -1;
  *out_bottleneck = achieved;
  return used;
}

}  // extern "C"
