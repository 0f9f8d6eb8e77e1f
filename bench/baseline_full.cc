// Complete reference-algorithm CPU baseline: best-score-at-wall-clock.
//
// The hot-loop stand-ins (baseline_nqueens.cc / baseline_scheduling.cc)
// measure only the reference's candidate-rescore throughput.  This binary
// runs the reference's ENTIRE algorithm end-to-end so the north star —
// "equal-or-better solution quality at equal wall-clock" (BASELINE.md) —
// can be measured directly instead of inferred from throughput ratios:
//
//   - LocalSearch::execute with tabu filter before scoring and window
//     truncation AFTER the filter (ref local-search/src/local_search.rs:
//     301-343: filter -> score -> take(window) -> sort -> step to best
//     even if worse, strict-improvement best tracking, no-improvement bail);
//   - History: VecDeque+HashSet tabu with the reference's inverted age
//     drain preserved verbatim (ref local_search.rs:182-195 — entries NOT
//     yet past the expiry horizon are drained, so the tabu set stays nearly
//     empty; reproducing the quirk keeps the baseline honest), BTreeSet
//     elite archive with evict-worst-if-leq (ref local_search.rs:205-218);
//   - AcceptanceCriterion: score-blind weighted 1:5:1 choice among
//     {current, new, random elite} (ref iterated_local_search.rs:51-71);
//   - IteratedLocalSearch::execute_round: best early-exit, full random
//     restart every 50 rounds, perturb -> LS -> chose -> accept
//     (ref iterated_local_search.rs:173-202);
//   - NQueens domain: conflict-weighted col sampling without replacement
//     (amount = clamp(n/20, 1, #conflicted), weight = score + 1e-4, then
//     uniform num_cols in 1..=amount of those), all rows per chosen col,
//     full O(n^2) rescore per candidate clone (ref nqueens/src/lib.rs:
//     163-256, 74-87); {ChangeSubset:100, DoNothing:10} perturbation with
//     elite-aware intensify/diversify (lib.rs:258-320);
//   - Scheduling domain: infinite random {ChangeDay:1, SwapDays:4} proposer
//     (ref employee-scheduling/src/lib.rs:422-491), the 8-constraint full
//     rescore (lib.rs:265-374; hash-map window counts replaced by
//     semantically-identical array sliding windows — a strictly FASTER
//     baseline implementation of the same scoring function), phantom
//     (end_date+1) slot in the assignment vector participating in identity
//     and perturbation but not scoring (lib.rs:404-419 vs :181-191);
//     {ChangeDaysSubsetRandomly:100, DoNothing:10} perturbation
//     (lib.rs:561-613).
//
// RNG: std::mt19937_64 stands in for ChaCha20 (same role: a seeded,
// deterministic generator; the reference's exact stream is not part of the
// contract being measured).
//
// Instrumentation: every solution the search HOLDS (the initial solution,
// restarts, and `current` after each applied move) updates a running best;
// when the wall clock crosses each requested budget the best-so-far is
// recorded.  This is still GENEROUS to the baseline — the reference CLI
// only surfaces History's elite best after complete rounds (ref
// main.rs:89-93), and we additionally credit transient mid-descent dips
// of `current` that the reference's "last strictly-improving" descent
// result forgets (ref local_search.rs:326-328).  Evaluated-but-rejected
// window candidates are NOT credited: the device side's probe only sees
// solutions its engine holds (elite-archive inserts), so crediting the
// baseline's rejected candidates would compare a best-of-everything-scored
// envelope against a best-solution-held trajectory.
//
// Build: g++ -O3 -march=native -o baseline_full baseline_full.cc
// Run:   ./baseline_full nqueens <n> <budgets,csv,seconds> [seed]
//        ./baseline_full scheduling <days> <emps> <budgets> [seed] [holidays]
// Output: one JSON line on stdout.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <random>
#include <set>
#include <string>
#include <unordered_set>
#include <vector>

using Clock = std::chrono::steady_clock;
using Sol = std::vector<int32_t>;
using Rng = std::mt19937_64;

static uint64_t rand_below(Rng& rng, uint64_t n) {
  // Unbiased enough for a baseline; n is tiny relative to 2^64.
  return rng() % n;
}

struct SolHash {
  size_t operator()(const Sol& v) const {
    uint64_t h = 1469598103934665603ull;
    for (int32_t x : v) {
      h ^= (uint64_t)(uint32_t)x;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

struct Score {
  double hard = 0, soft = 0;
  bool operator<(const Score& o) const {
    if (hard != o.hard) return hard < o.hard;
    return soft < o.soft;
  }
  bool operator==(const Score& o) const {
    return hard == o.hard && soft == o.soft;
  }
  bool leq(const Score& o) const { return *this < o || *this == o; }
  bool is_best() const { return hard == 0 && soft == 0; }
};

struct Scored {
  Score score;
  Sol sol;
  // Reference ScoredSolution derives Ord with the score field first
  // (ref local_search.rs:29-37), so ties break on the solution.
  bool operator<(const Scored& o) const {
    if (score < o.score) return true;
    if (o.score < score) return false;
    return sol < o.sol;
  }
};

// ---------------------------------------------------------------------------
// Wall-budget probe: tracks the best score ever evaluated and snapshots it
// as each budget passes.
struct Probe {
  std::vector<double> budgets;  // ascending, seconds
  std::vector<Score> best_at;
  size_t next = 0;
  Score best{1e18, 1e18};
  long long moves = 0;
  Clock::time_point t0 = Clock::now();

  double elapsed() const {
    return std::chrono::duration<double>(Clock::now() - t0).count();
  }
  // Every evaluation counts toward moves/s and advances the wall probe...
  void observe_eval() {
    ++moves;
    tick();
  }
  // ...but only solutions the search HOLDS update the best (see header).
  void observe_held(const Score& s) {
    if (s < best) best = s;
    tick();
  }
  void tick() {
    if (next >= budgets.size()) return;
    const double e = elapsed();
    while (next < budgets.size() && e >= budgets[next]) {
      best_at.push_back(best);
      ++next;
    }
  }
  bool done() {
    tick();
    return next >= budgets.size();
  }
  void finish() {
    while (next < budgets.size()) {
      best_at.push_back(best);
      ++next;
    }
  }
};

// ---------------------------------------------------------------------------
// History — tabu ring + elite archive, reference semantics verbatim.
struct HistEntry {
  Scored ss;
  uint64_t iteration;
};

struct History {
  std::set<Scored> best;  // BTreeSet<ScoredSolution>
  size_t best_cap;
  std::deque<HistEntry> all;  // front = newest (push_front like the ref)
  size_t all_cap;
  std::unordered_set<Sol, SolHash> lookup;
  uint64_t expiry;
  uint64_t iteration_count = 0;

  History(size_t bc, size_t ac, uint64_t ex)
      : best_cap(bc), all_cap(ac), expiry(ex) {}

  void seen_solution(const Scored& s) {  // ref local_search.rs:155-162
    ++iteration_count;
    pop_for_age();
    if (lookup.count(s.sol)) return;
    pop_for_size();
    all.push_front({s, iteration_count});
    lookup.insert(s.sol);
  }
  void pop_for_size() {  // ref local_search.rs:173-180
    while (all.size() > all_cap) {
      lookup.erase(all.back().ss.sol);
      all.pop_back();
    }
  }
  void pop_for_age() {  // ref local_search.rs:182-195, quirk preserved
    while (!all.empty() &&
           all.back().iteration + expiry >= iteration_count) {
      lookup.erase(all.back().ss.sol);
      all.pop_back();
    }
  }
  bool is_tabu(const Sol& s) const { return lookup.count(s) != 0; }
  bool is_best_solution(const Scored& s) const { return best.count(s) != 0; }
  void chose(const Scored& s) {  // ref local_search.rs:205-218
    if (best.size() < best_cap) {
      best.insert(s);
      return;
    }
    const Scored worst = *best.rbegin();
    if (s.score.leq(worst.score)) {
      best.erase(worst);
      best.insert(s);
    }
  }
  const Scored* get_best() const {
    return best.empty() ? nullptr : &*best.begin();
  }
  bool get_random_best(Rng& rng, Scored& out) const {
    if (best.empty()) return false;
    auto it = best.begin();
    std::advance(it, (size_t)rand_below(rng, best.size()));
    out = *it;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Engine: LocalSearch + IteratedLocalSearch over a Domain providing
//   Score score(const Sol&)            full rescore
//   Sol initial(Rng&)                  random initial solution
//   MoveGen moves(const Sol&, Rng&)    per-LS-iteration neighborhood stream
//   Sol perturb(const Scored&, const History&, Rng&)
template <typename Domain>
struct Engine {
  Domain& dom;
  Probe& probe;
  Rng rng;
  uint64_t ls_max_iterations;
  size_t window;
  History ls_history;   // LocalSearch-private (tabu) — ref LocalSearch::new
  History ils_history;  // ILS-level (elites) — ref IteratedLocalSearch::new
  uint64_t ils_max;
  uint64_t allow_no_improvement_for;
  Scored current;
  uint64_t iteration = 0;

  Engine(Domain& d, Probe& p, uint64_t seed, uint64_t ls_max, size_t window_,
         size_t best_cap, size_t all_cap, uint64_t expiry, uint64_t ils_max_,
         uint64_t allow)
      : dom(d),
        probe(p),
        rng(seed),
        ls_max_iterations(ls_max),
        window(window_),
        ls_history(best_cap, all_cap, expiry),
        ils_history(best_cap, all_cap, expiry),
        ils_max(ils_max_),
        allow_no_improvement_for(allow) {
    current = scored(dom.initial(rng));  // ref iterated_local_search.rs:141
    probe.observe_held(current.score);
  }

  Scored scored(Sol s) {
    Score sc = dom.score(s);
    probe.observe_eval();
    return Scored{sc, std::move(s)};
  }

  Scored ls_execute(Sol start) {  // ref local_search.rs:301-343
    Scored cur = scored(std::move(start));
    probe.observe_held(cur.score);
    Scored best = cur;
    uint64_t no_improvement_for = 0;
    for (uint64_t it = 0; it < ls_max_iterations; ++it) {
      ls_history.seen_solution(cur);
      if (cur.score.is_best()) return cur;
      auto gen = dom.moves(cur.sol, rng);
      Scored nb;
      bool have = false;
      size_t taken = 0;
      Sol cand;
      while (taken < window && gen.next(cand, rng)) {
        if (ls_history.is_tabu(cand)) continue;  // filter BEFORE scoring
        Scored sc = scored(std::move(cand));
        ++taken;
        if (!have || sc < nb) {
          nb = std::move(sc);
          have = true;
        }
        if (probe.done()) break;
      }
      if (!have) break;
      if (nb.score < cur.score) {
        best = nb;
        no_improvement_for = 0;
      } else {
        ++no_improvement_for;
        if (no_improvement_for >= allow_no_improvement_for) break;
      }
      cur = std::move(nb);  // move even if worse (ref :335)
      probe.observe_held(cur.score);
      if (probe.done()) break;
    }
    return best;
  }

  void execute_round() {  // ref iterated_local_search.rs:173-202
    ++iteration;
    if (const Scored* b = ils_history.get_best())
      if (b->score.is_best()) return;
    if (iteration % 50 == 0) {
      current = scored(dom.initial(rng));
      probe.observe_held(current.score);
    }
    Sol perturbed = dom.perturb(current, ils_history, rng);
    Scored nw = ls_execute(std::move(perturbed));
    ils_history.chose(nw);
    // Acceptance: weighted {current:1, new:5, random elite:1}
    Scored rb;
    const bool has = ils_history.get_random_best(rng, rb);
    const uint64_t r = rand_below(rng, has ? 7 : 6);
    if (r < 1) {
      // keep current
    } else if (r < 6) {
      current = std::move(nw);
    } else {
      current = std::move(rb);
    }
  }

  void run() {
    while (iteration < ils_max && !probe.done()) {
      execute_round();
      const Scored* b = ils_history.get_best();
      if (b && b->score.is_best()) break;
    }
    probe.finish();
  }
};

// ---------------------------------------------------------------------------
// NQueens domain (ref examples/nqueens/src/lib.rs).
struct NQueens {
  int n;

  Score score(const Sol& rows) const {  // ref lib.rs:74-87 (x2 convention)
    long total = 0;
    for (int c1 = 0; c1 < n; ++c1)
      for (int c2 = c1 + 1; c2 < n; ++c2) {
        const long rd = (long)rows[c2] - rows[c1];
        const long cd = c2 - c1;
        if (rd == 0 || (rd < 0 ? -rd : rd) == cd) total += 2;
      }
    return Score{(double)total, 0.0};
  }

  std::vector<long> col_scores(const Sol& rows) const {
    std::vector<long> cs(n, 0);
    for (int c1 = 0; c1 < n; ++c1)
      for (int c2 = c1 + 1; c2 < n; ++c2) {
        const long rd = (long)rows[c2] - rows[c1];
        const long cd = c2 - c1;
        if (rd == 0 || (rd < 0 ? -rd : rd) == cd) {
          ++cs[c1];
          ++cs[c2];
        }
      }
    return cs;
  }

  Sol initial(Rng& rng) const {  // ref lib.rs:156-160: shuffled permutation
    Sol rows(n);
    for (int i = 0; i < n; ++i) rows[i] = i;
    std::shuffle(rows.begin(), rows.end(), rng);
    return rows;
  }

  struct MoveGen {
    const Sol* start;
    std::vector<int> cols;  // chosen cols, every row each
    int board;
    size_t col_idx = 0;
    int value = 0;
    bool next(Sol& out, Rng&) {
      if (value >= board) {
        ++col_idx;
        value = 0;
      }
      if (col_idx >= cols.size()) return false;
      out = *start;
      out[cols[col_idx]] = value++;
      return true;
    }
  };

  MoveGen moves(const Sol& start, Rng& rng) const {  // ref lib.rs:177-255
    std::vector<std::pair<int, double>> conf;  // (col, weight), col-sorted
    const std::vector<long> cs = col_scores(start);
    for (int c = 0; c < n; ++c)
      if (cs[c] != 0) conf.emplace_back(c, (double)cs[c] + 1e-4);
    MoveGen g{&start, {}, n};
    if (conf.empty()) return g;
    const size_t amount =
        std::clamp((size_t)(n / 20), (size_t)1, conf.size());
    // choose_multiple_weighted without replacement (ref lib.rs:198)
    std::vector<int> weighted;
    double total = 0;
    for (auto& p : conf) total += p.second;
    for (size_t i = 0; i < amount; ++i) {
      double r = std::uniform_real_distribution<double>(0.0, total)(rng);
      size_t j = 0;
      double acc = 0;
      for (; j + 1 < conf.size(); ++j) {
        acc += conf[j].second;
        if (r < acc) break;
      }
      weighted.push_back(conf[j].first);
      total -= conf[j].second;
      conf.erase(conf.begin() + (long)j);
    }
    // num_cols uniform in 1..=amount, then uniform subset (ref lib.rs:202-203)
    const size_t num_cols = 1 + (size_t)rand_below(rng, weighted.size());
    std::shuffle(weighted.begin(), weighted.end(), rng);
    weighted.resize(num_cols);
    g.cols = std::move(weighted);
    return g;
  }

  Sol perturb(const Scored& cur, const History& h, Rng& rng) const {
    // ref lib.rs:291-319: {ChangeSubset:100, DoNothing:10}
    Sol out = cur.sol;
    if (rand_below(rng, 110) >= 100) return out;  // DoNothing
    const uint64_t lo_cap = std::max<uint64_t>(1, (uint64_t)n / 20);
    const uint64_t hi_cap = std::max<uint64_t>(1, (uint64_t)n / 2);
    const uint64_t k = h.is_best_solution(cur)
                           ? 1 + rand_below(rng, lo_cap)
                           : 1 + rand_below(rng, hi_cap);
    std::vector<int> idx(n);
    for (int i = 0; i < n; ++i) idx[i] = i;
    for (uint64_t i = 0; i < k; ++i) {  // partial Fisher-Yates
      const size_t j = i + (size_t)rand_below(rng, (uint64_t)n - i);
      std::swap(idx[i], idx[j]);
      out[idx[i]] = (int32_t)rand_below(rng, (uint64_t)n);
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// Employee scheduling domain (ref examples/employee-scheduling/src/lib.rs).
// Day 0 is a Monday (both the reference CLI start 2022-05-09 and the bench
// instance start 2024-01-01 are Mondays); weekend = day%7 in {5, 6}.
// The assignment vector has D+1 entries: the reference's initial generator
// pushes one day past end_date (lib.rs:404-419), and that phantom slot is
// part of solution identity and perturbation but never scored (scoring
// iterates get_days_to_employees, which stops at end_date, lib.rs:181-191).
struct Scheduling {
  int d;      // real days
  int n_emp;
  std::vector<uint8_t> holiday;  // [E * D]

  static bool is_weekend(int day) { return (day % 7) >= 5; }

  Score score(const Sol& a) const {  // ref lib.rs:265-374
    Score s;
    // H1 — holidays: for every (employee, holiday) pair, +1 if assigned.
    for (int day = 0; day < d; ++day)
      if (holiday[(size_t)a[day] * d + day]) s.hard += 1.0;
    // H2 — same employee two consecutive days, windows(2).
    for (int day = 0; day + 1 < d; ++day)
      if (a[day] == a[day + 1]) s.hard += 1.0;
    // H3 — consecutive weekends, windows(9).
    for (int w = 0; w + 9 <= d; ++w) {
      if (!(is_weekend(w) && is_weekend(w + 1))) continue;
      if (a[w] == a[w + 7]) s.hard += 1.0;
      if (a[w] == a[w + 8]) s.hard += 1.0;
      if (a[w + 1] == a[w + 7]) s.hard += 1.0;
      if (a[w + 1] == a[w + 8]) s.hard += 1.0;
    }
    // H4 — >3 shifts per 14-day window; S1 — >2 per 7-day window.
    // Array sliding windows: identical counts to the reference's per-window
    // HashMap `.counts()` (lib.rs:317-339), constant-factor faster.
    s.hard += sliding_violations(a, 14, 3);
    s.soft += sliding_violations(a, 7, 2);
    // S2 — weekday consistency Mon-Fri (lib.rs:194-218).
    {
      std::vector<int> cnt((size_t)n_emp);
      for (int wd = 0; wd < 5; ++wd) {
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int day = wd; day < d; day += 7) ++cnt[a[day]];
        int distinct = 0, mn = 1 << 30;
        for (int e = 0; e < n_emp; ++e)
          if (cnt[e] > 0) {
            ++distinct;
            if (cnt[e] < mn) mn = cnt[e];
          }
        if (distinct > 1) s.soft += (double)mn;
      }
    }
    // S3/S4 — max-min spreads over employees with >=1 day (lib.rs:344-365).
    {
      std::vector<int> tot((size_t)n_emp, 0), wk((size_t)n_emp, 0);
      for (int day = 0; day < d; ++day) {
        ++tot[a[day]];
        if (is_weekend(day)) ++wk[a[day]];
      }
      int mn_t = 1 << 30, mx_t = -1, mn_w = 1 << 30, mx_w = -1, present = 0;
      for (int e = 0; e < n_emp; ++e)
        if (tot[e] > 0) {
          ++present;
          mn_t = std::min(mn_t, tot[e]);
          mx_t = std::max(mx_t, tot[e]);
          mn_w = std::min(mn_w, wk[e]);
          mx_w = std::max(mx_w, wk[e]);
        }
      if (present >= 2) s.soft += (double)(mx_t - mn_t) + (double)(mx_w - mn_w);
    }
    return s;
  }

  double sliding_violations(const Sol& a, int width, int limit) const {
    if (d < width) return 0.0;
    std::vector<int> cnt((size_t)n_emp, 0);
    int over = 0;
    for (int k = 0; k < width; ++k)
      if (++cnt[a[k]] == limit + 1) ++over;
    double v = over;
    for (int w = 1; w + width <= d; ++w) {
      if (cnt[a[w - 1]]-- == limit + 1) --over;
      if (++cnt[a[w + width - 1]] == limit + 1) ++over;
      v += over;
    }
    return v;
  }

  Sol initial(Rng& rng) const {  // D+1 entries incl. the phantom slot
    Sol a(d + 1);
    for (int i = 0; i <= d; ++i) a[i] = (int32_t)rand_below(rng, n_emp);
    return a;
  }

  struct MoveGen {  // infinite random stream (ref lib.rs:455-482)
    const Sol* start;
    int d, n_emp;
    bool next(Sol& out, Rng& rng) {
      out = *start;
      if (rand_below(rng, 5) < 1) {  // ChangeDay:1
        out[rand_below(rng, d)] = (int32_t)rand_below(rng, n_emp);
      } else {  // SwapDays:4 — two distinct real days
        const int d1 = (int)rand_below(rng, d);
        int d2 = (int)rand_below(rng, d - 1);
        if (d2 >= d1) ++d2;
        std::swap(out[d1], out[d2]);
      }
      return true;
    }
  };

  MoveGen moves(const Sol& start, Rng&) const {
    return MoveGen{&start, d, n_emp};
  }

  Sol perturb(const Scored& cur, const History& h, Rng& rng) const {
    // ref lib.rs:588-612: {ChangeDaysSubsetRandomly:100, DoNothing:10},
    // over ALL slots incl. the phantom (total_days = len of the vector).
    Sol out = cur.sol;
    if (rand_below(rng, 110) >= 100) return out;
    const uint64_t total = out.size();
    const uint64_t lo_cap = std::max<uint64_t>(1, total / 20);
    const uint64_t hi_cap = std::max<uint64_t>(1, total / 2);
    const uint64_t k = h.is_best_solution(cur) ? 1 + rand_below(rng, lo_cap)
                                               : 1 + rand_below(rng, hi_cap);
    std::vector<int> idx(total);
    for (size_t i = 0; i < total; ++i) idx[i] = (int)i;
    for (uint64_t i = 0; i < k; ++i) {
      const size_t j = i + (size_t)rand_below(rng, total - i);
      std::swap(idx[i], idx[j]);
      out[idx[i]] = (int32_t)rand_below(rng, n_emp);
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
static std::vector<double> parse_budgets(const char* s) {
  std::vector<double> out;
  std::string str(s);
  size_t pos = 0;
  while (pos < str.size()) {
    size_t comma = str.find(',', pos);
    if (comma == std::string::npos) comma = str.size();
    out.push_back(atof(str.substr(pos, comma - pos).c_str()));
    pos = comma + 1;
  }
  std::sort(out.begin(), out.end());
  return out;
}

static void print_json(const char* domain, const Probe& probe,
                       const Score& final_best) {
  printf("{\"domain\": \"%s\", \"budgets\": [", domain);
  for (size_t i = 0; i < probe.budgets.size(); ++i)
    printf("%s%g", i ? ", " : "", probe.budgets[i]);
  printf("], \"best_hard\": [");
  for (size_t i = 0; i < probe.best_at.size(); ++i)
    printf("%s%g", i ? ", " : "", probe.best_at[i].hard);
  printf("], \"best_soft\": [");
  for (size_t i = 0; i < probe.best_at.size(); ++i)
    printf("%s%g", i ? ", " : "", probe.best_at[i].soft);
  printf("], \"moves\": %lld, \"elapsed\": %.3f, \"moves_per_sec\": %.1f, "
         "\"final_hard\": %g, \"final_soft\": %g}\n",
         probe.moves, probe.elapsed(), probe.moves / probe.elapsed(),
         final_best.hard, final_best.soft);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage: %s nqueens <n> <budgets> [seed]\n"
            "       %s scheduling <days> <emps> <budgets> [seed] [holidays]\n",
            argv[0], argv[0]);
    return 2;
  }
  if (!strcmp(argv[1], "nqueens")) {
    const int n = argc > 2 ? atoi(argv[2]) : 1000;
    Probe probe;
    probe.budgets = parse_budgets(argc > 3 ? argv[3] : "2.3,10,60");
    const uint64_t seed = argc > 4 ? strtoull(argv[4], nullptr, 10) : 42;
    // Optional round-budget override: 0 = unlimited (wall budget binds).
    // The reference CLI fixes 10'000 rounds; for the quality-at-wall
    // comparison an uncapped baseline is strictly stronger.
    uint64_t rounds = argc > 5 ? strtoull(argv[5], nullptr, 10) : 10'000;
    if (rounds == 0) rounds = ~0ull;
    NQueens dom{n};
    // ref examples/nqueens/src/main.rs:129-135
    Engine<NQueens> eng(dom, probe, seed, /*ls_max=*/10'000,
                        /*window=*/(size_t)(5 * n), /*best_cap=*/32,
                        /*all_cap=*/100'000, /*expiry=*/10'000,
                        /*ils_max=*/rounds, /*allow=*/5);
    probe.t0 = Clock::now();  // exclude setup; generous to the baseline
    eng.run();
    print_json("nqueens", probe, probe.best);
    fprintf(stderr,
            "nqueens n=%d: %lld scored in %.2fs (%.0f/s), rounds=%llu, "
            "best=%g\n",
            n, probe.moves, probe.elapsed(), probe.moves / probe.elapsed(),
            (unsigned long long)eng.iteration, probe.best.hard);
  } else if (!strcmp(argv[1], "scheduling")) {
    const int d = argc > 2 ? atoi(argv[2]) : 365;
    const int n_emp = argc > 3 ? atoi(argv[3]) : 20;
    Probe probe;
    probe.budgets = parse_budgets(argc > 4 ? argv[4] : "2.3,10,60");
    const uint64_t seed = argc > 5 ? strtoull(argv[5], nullptr, 10) : 42;
    const int with_holidays = argc > 6 ? atoi(argv[6]) : 1;
    uint64_t rounds = argc > 7 ? strtoull(argv[7], nullptr, 10) : 250;
    if (rounds == 0) rounds = ~0ull;
    Scheduling dom{d, n_emp, std::vector<uint8_t>((size_t)n_emp * d, 0)};
    if (with_holidays) {
      // The bench instance's synthetic holidays (bench.py): employee e gets
      // dates (17e + 11k) % d for k in 0..10.
      for (int e = 0; e < n_emp; ++e)
        for (int k = 0; k < 10; ++k)
          dom.holiday[(size_t)e * d + (17 * e + 11 * k) % d] = 1;
    }
    // ref examples/employee-scheduling/src/main.rs:25-31
    Engine<Scheduling> eng(dom, probe, seed, /*ls_max=*/1'000,
                           /*window=*/100, /*best_cap=*/64,
                           /*all_cap=*/100'000, /*expiry=*/1'000,
                           /*ils_max=*/rounds, /*allow=*/20);
    probe.t0 = Clock::now();
    eng.run();
    print_json("scheduling", probe, probe.best);
    fprintf(stderr,
            "scheduling d=%d e=%d: %lld scored in %.2fs (%.0f/s), "
            "rounds=%llu, best=(%g, %g)\n",
            d, n_emp, probe.moves, probe.elapsed(),
            probe.moves / probe.elapsed(), (unsigned long long)eng.iteration,
            probe.best.hard, probe.best.soft);
  } else {
    fprintf(stderr, "unknown domain %s\n", argv[1]);
    return 2;
  }
  return 0;
}
