"""Employee-scheduling domain: 4 hard + 4 soft constraints, delta-evaluated.

Reference semantics (reference examples/employee-scheduling/src/lib.rs):

- solution: one employee per day, ``assign[day] = employee`` (ref lib.rs:129-146;
  identity/hash derive only from the assignment vector);
- score: lexicographic ``(hard, soft)`` float pair (ref lib.rs:239-249);
- constraints (ref ScheduleSolutionScoreCalculator, lib.rs:265-374):
  - H1 employee works own holiday: +1 each (ref :272-280)
  - H2 same employee two consecutive days: +1 per adjacent pair (ref :285-292)
  - H3 consecutive weekends: windows(9) starting on a weekend pair compare
    positions {0,1} x {7,8}: +1 per equal pair (ref :294-315)
  - H4 > 3 shifts in any 14-day window: +1 per (window, employee) (ref :317-327)
  - S1 > 2 shifts in any 7-day window: +1 per (window, employee) (ref :329-339)
  - S2 weekday-consistency: per weekday Mon-Fri with >1 distinct employee,
    add the minimum per-employee count among employees appearing on that
    weekday (ref get_weekday_to_employee_counts_score, :194-218)
  - S3 max-min spread of total days over employees with >= 1 day (ref :344-351)
  - S4 max-min spread of weekend days over employees with >= 1 day (ref :353-365)
- neighborhood: an *infinite random* move stream, weights
  {ChangeDay: 1, SwapDays: 4}, truncated by the engine window (ref
  ScheduleRandomMoveProposer, lib.rs:428-491 + window take at
  local_search.rs:321) — here a fixed batch of W random moves;
- perturbation: {ChangeDaysSubsetRandomly: 100, DoNothing: 10}, altering
  ``U[1, D/20]`` days near elites else ``U[1, D/2]`` (ref lib.rs:567-613).

Candidate scoring is **delta evaluation** (SURVEY.md §7 hard-part 1), the
scheduling analog of the nqueens counter deltas: a ChangeDay/SwapDays move
touches at most 2 days, so only windows CONTAINING a changed day can change
value.  Per candidate we dynamic-slice a 27-day region around each changed
day (contiguous slices, never random gathers), recompute the K-wide window
values (K = 2/7/9/14) under the old and new local assignment, and sum the
differences over exactly the affected window starts — windows double-covered
by both changed days are masked out of the second day's sum.  Employee-level
aggregates (S2 weekday counts, S3/S4 totals) are maintained as [5,E]/[E]
count tensors updated by +-1 one-hot adds per candidate.  The result is
EXACT: tests prove delta scores == the full rescore for every candidate.
Cost per candidate is O(R·E) with R = 27 region days, independent of D —
the full-rescore path is O(D·E) per candidate (A/B kept as
``proposer="rescore"``).

All full scores remain one fused tensor pass: one-hot day x employee
matrix, prefix-sum window counters for the 7/14-day windows, shifted
comparisons for adjacency/weekend patterns — no per-window HashMap counting
(ref lib.rs:317-339) anywhere.

Divergence note: the reference's initial generator materializes one phantom
extra day past ``end_date`` (ref lib.rs:404-419 pushes then breaks) which is
never scored and only perturbs tabu identity; we use exactly D days.
"""

from __future__ import annotations

from functools import lru_cache

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.problem import Neighborhood, Problem
from constraint_solver_tpu.ops.fingerprint import (
    fingerprint_i32,
    fp_update,
    position_hash_planes,
)
from constraint_solver_tpu.ops.lex import lex_argmin, make_score

# Delta-evaluation region: the widest window is 14 days (H4), so windows
# containing day d start in [d-13, d] and span days [d-13, d+13].
PAD = 13
REG = 2 * PAD + 1  # 27


def region_deltas(
    sl_old, wk_sl, d1, n1, d2, n2, e1, e2, dj, d_excl, use_excl, d_days
):
    """(hard_delta, s1_delta) over windows containing day ``dj``.

    ``sl_old``/``wk_sl`` are the 27-day assignment/weekend slices covering
    global days [dj-13, dj+13] (out-of-range days filled with employee -1 /
    weekend False).  Both point changes that fall inside the region are
    applied, and per-window value differences are summed over starts
    w in [dj-K+1, dj] for K = 2 (H2), 9 (H3), 14 (H4), 7 (S1).  With
    ``use_excl``, starts in [d_excl-K+1, d_excl] are excluded (already
    counted for that day).

    H4/S1 window counts are tracked only for the <= 4 employees a move can
    touch ({e1, n1, e2, n2}, first-occurrence weighted so duplicates count
    once) — every other employee's per-window count is unchanged — so the
    per-candidate cost is O(R), independent of E.

    Module-level so the date-sharded solver (parallel/seq_solver.py) reuses
    the exact same float operations — trajectory equality with the dense
    solver requires bit-identical candidate scores.
    """
    f32 = jnp.float32
    iota = jnp.arange(REG, dtype=jnp.int32)
    sl_new = jnp.where(iota == (d1 - dj + PAD), n1, sl_old)
    sl_new = jnp.where(iota == (d2 - dj + PAD), n2, sl_new)

    w_all = dj - PAD + jnp.arange(REG, dtype=jnp.int32)  # window starts

    def fam_mask(k):
        m = (w_all >= dj - k + 1) & (w_all <= dj)
        m &= (w_all >= 0) & (w_all <= d_days - k)
        if use_excl:
            m &= ~((w_all >= d_excl - k + 1) & (w_all <= d_excl))
        return m.astype(f32)

    def shift(x, k, fill):
        return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])

    # H2 — value at start w: a[w] == a[w+1].
    def h2_vals(sl):
        return (sl == shift(sl, 1, -2)).astype(f32)

    # H3 — weekend-pair window: sum of {0,1} x {7,8} equalities.
    def h3_vals(sl):
        a0, a1 = sl, shift(sl, 1, -2)
        a7, a8 = shift(sl, 7, -3), shift(sl, 8, -4)
        cond = wk_sl & shift(wk_sl, 1, False)
        eqs = (
            (a0 == a7).astype(f32) + (a0 == a8) + (a1 == a7) + (a1 == a8)
        )
        return jnp.where(cond, eqs, 0.0)

    d_h2 = jnp.sum(fam_mask(2) * (h2_vals(sl_new) - h2_vals(sl_old)))
    d_h3 = jnp.sum(fam_mask(9) * (h3_vals(sl_new) - h3_vals(sl_old)))

    # H4/S1 — sliding counts of the 4 move employees, dedup-weighted.
    emps = jnp.stack([e1, n1, e2, n2])  # [4]
    first = jnp.stack(
        [
            jnp.bool_(True),
            n1 != e1,
            (e2 != e1) & (e2 != n1),
            (n2 != e1) & (n2 != n1) & (n2 != e2),
        ]
    ).astype(f32)  # first-occurrence weights [4]

    def csum4(sl):
        ind = (sl[None, :] == emps[:, None]).astype(f32)  # [4, REG]
        cs = jnp.cumsum(ind, axis=1)
        return jnp.concatenate([jnp.zeros((4, 1), f32), cs], axis=1)

    cs_old, cs_new = csum4(sl_old), csum4(sl_new)

    def d_fam(k, thresh):
        def over(cs):
            c = cs[:, k:] - cs[:, :-k]  # [4, REG+1-k]
            v = (c > thresh).astype(f32)
            return jnp.pad(v, ((0, 0), (0, k - 1)))  # [4, REG]

        per_emp = over(cs_new) - over(cs_old)  # [4, REG]
        return jnp.sum(fam_mask(k)[None, :] * first[:, None] * per_emp)

    d_h4 = d_fam(14, 3)
    d_s1 = d_fam(7, 2)
    return d_h2 + d_h3 + d_h4, d_s1


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Static problem data: day count, employee count, calendar layout, and
    a dense employee x day holiday mask (the reference's
    ``employee_to_holidays`` map, ref lib.rs:251-259)."""

    num_days: int
    num_employees: int
    start_weekday: int  # 0 = Monday (chrono Weekday::Mon == date.weekday())
    holiday_mask: tuple = ()  # hashable; use holiday_array() for the ndarray

    @staticmethod
    def from_dates(
        start_date: datetime.date,
        end_date: datetime.date,
        num_employees: int,
        employee_holidays: dict[int, list[datetime.date]] | None = None,
    ) -> "ScheduleSpec":
        num_days = (end_date - start_date).days + 1
        mask = np.zeros((num_employees, num_days), bool)
        for emp, days in (employee_holidays or {}).items():
            for day in days:
                idx = (day - start_date).days
                if 0 <= idx < num_days:
                    mask[emp, idx] = True
        return ScheduleSpec(
            num_days=num_days,
            num_employees=num_employees,
            start_weekday=start_date.weekday(),
            holiday_mask=tuple(map(tuple, mask.tolist())),
        )

    def holiday_array(self) -> np.ndarray:
        if not self.holiday_mask:
            return np.zeros((self.num_employees, self.num_days), bool)
        return np.asarray(self.holiday_mask, bool)

    def weekdays(self) -> np.ndarray:
        return (self.start_weekday + np.arange(self.num_days)) % 7

    def is_weekend(self) -> np.ndarray:
        return self.weekdays() >= 5  # Sat=5, Sun=6


def sample_random_moves(key, w_size: int, d_days: int, n_emp: int):
    """W random moves ~ {ChangeDay: 1, SwapDays: 4} (ref lib.rs:435); swap
    day pair uniform over distinct pairs via d1 + U[1, D) mod D
    (ref choose_multiple(2), lib.rs:472-477).  Module-level so the
    date-sharded solver (parallel/seq_solver.py) draws BIT-IDENTICAL moves
    from the replicated key — its trajectory-equality contract with the
    dense solver depends on this being the single definition."""
    k_type, k_d1, k_off, k_emp = jax.random.split(key, 4)
    is_swap = jax.random.uniform(k_type, (w_size,)) < 0.8
    d1 = jax.random.randint(k_d1, (w_size,), 0, d_days, jnp.int32)
    off = jax.random.randint(k_off, (w_size,), 1, max(d_days, 2), jnp.int32)
    d2 = (d1 + off) % d_days
    new_emp = jax.random.randint(k_emp, (w_size,), 0, n_emp, jnp.int32)
    return is_swap, d1, d2, new_emp


def _cat_blocks(blocks):
    """Concatenate (scores, moves, valid, fp_deltas) candidate blocks into
    one Neighborhood (the dense proposer's ChangeDay / random-swap /
    diagonal sections).

    scores/fp_deltas arrive as per-block PLANE PAIRS ((hard, soft) /
    (lane0, lane1), each [w]); the planes are concatenated separately and
    stacked into the [W, 2] contract arrays once at the end — concatenating
    pre-stacked [w, 2] blocks materialized [W, 2] buffers whose tiled
    layout pads the trailing dim, and the relayout copies dominated a
    device trace on the hardware this was written for.  Not yet measured on
    the H100."""
    cat = lambda *xs: jnp.concatenate(xs)
    hard = cat(*[b[0][0] for b in blocks])
    soft = cat(*[b[0][1] for b in blocks])
    fp0 = cat(*[b[3][0] for b in blocks])
    fp1 = cat(*[b[3][1] for b in blocks])
    return Neighborhood(
        scores=jnp.stack([hard, soft], axis=-1),
        moves=jax.tree.map(cat, *[b[1] for b in blocks]),
        valid=cat(*[b[2] for b in blocks]),
        fp_deltas=jnp.stack([fp0, fp1], axis=-1),
    )


def _swap_fp_delta_planes(d1, e1, n1, d2, e2, n2):
    """XOR fingerprint delta of a two-point move as two uint32[...] planes
    (the incremental form of ops/fingerprint.py; ChangeDay has n2 == e2,
    whose hash terms cancel).  Planes, not [..., 2]: wide trailing-2 arrays
    pad under a tiled layout."""
    u = lambda x: x.astype(jnp.uint32)
    a0, a1 = position_hash_planes(d1, u(e1))
    b0, b1 = position_hash_planes(d1, u(n1))
    c0, c1 = position_hash_planes(d2, u(e2))
    e0, e1_ = position_hash_planes(d2, u(n2))
    return a0 ^ b0 ^ c0 ^ e0, a1 ^ b1 ^ c1 ^ e1_


def _swap_fp_deltas(d1, e1, n1, d2, e2, n2):
    """Stacked uint32[..., 2] form of ``_swap_fp_delta_planes`` (narrow
    batches only, e.g. the date-sharded solver's W=100 window)."""
    return jnp.stack(_swap_fp_delta_planes(d1, e1, n1, d2, e2, n2), axis=-1)


@lru_cache(maxsize=32)
def make_scheduling_problem(
    spec: ScheduleSpec,
    window_size: int = 100,
    proposer: str = "dense",
    n_swap_offsets: int = 4,
    n_rand_swaps: int = 64,
) -> Problem:
    """``proposer``:

    - "dense" (default, the accelerator-first neighborhood): every ChangeDay move
      (all D days x all E employees) delta-scored as ONE dense [D, E] block
      of shifted full-axis tensor ops — no per-candidate slicing, no
      gathers — plus ``n_swap_offsets`` dense SwapDays diagonals (all days
      swapped with the day ``delta`` later, ``delta`` ~ U[14, D) sampled per
      call) plus ``n_rand_swaps`` UNRESTRICTED random swap pairs scored by
      the exact overlapping-region path (close-pair swaps rearrange days
      inside a constraint window without touching totals — the move class
      the >= 14-day diagonals cannot express; adding them closed the
      soft-descent gap vs the random proposer).
      Divergence from the reference's 100-random-move window
      (ref lib.rs:428-491): the engine argmins over this much wider
      neighborhood, the same documented divergence as the nqueens A x n
      block.  Exactness of every block is proven against the full
      rescore in tests/test_scheduling_dense.py;
    - "random": the reference's used proposer — ``window_size`` random
      ChangeDay/SwapDays samples (ref ScheduleRandomMoveProposer,
      lib.rs:428-491), candidate scores by exact O(R·E) per-candidate delta
      evaluation (27-day regions around the changed days);
    - "rescore": identical sampling to "random", candidates scored by the
      O(D·E) full-rescore batch (kept for the delta-vs-rescore A/B —
      bit-identical trajectories to "random");
    - "systematic": the reference's deterministic rotate-each-day-through-
      all-successor-employees neighborhood (ref ScheduleMoveProposer,
      lib.rs:493-559 — constructed but commented out at lib.rs:59-60);
      employees are ordered by id, successor = (e + 1) mod E, yielding
      D x (E-1) candidates.
    """
    d_days = spec.num_days
    n_emp = spec.num_employees
    w_size = window_size
    f32 = jnp.float32
    holiday = jnp.asarray(spec.holiday_array())          # bool[E, D]
    holiday_de = jnp.asarray(spec.holiday_array().T, f32)  # f32[D, E]
    weekend = jnp.asarray(spec.is_weekend())             # bool[D]
    weekend_f = weekend.astype(f32)                      # f32[D]
    weekday = jnp.asarray(spec.weekdays(), jnp.int32)    # int32[D]
    # weekday one-hot for Mon..Fri rows: [5, D]
    wd_onehot = jnp.asarray(
        (spec.weekdays()[None, :] == np.arange(5)[:, None]), jnp.float32
    )
    # Padded static tables for the 27-day delta regions.  Padding days hold
    # employee -1 (matches nothing, one-hots to zero) and weekend False.
    wk_pad = jnp.concatenate(
        [jnp.zeros((PAD,), bool), weekend, jnp.zeros((PAD,), bool)]
    )
    # Constant position-hash table h(d, e) for the dense ChangeDay batch
    # fingerprints (ops/fingerprint.py XOR structure), one uint32[D, E]
    # plane per fingerprint lane.
    h_de0, h_de1 = position_hash_planes(
        jnp.arange(d_days, dtype=jnp.int32)[:, None],
        jnp.broadcast_to(
            jnp.arange(n_emp, dtype=jnp.uint32)[None, :], (d_days, n_emp)
        ),
    )

    # -- aggregate-level soft scores (shared by full and delta paths) ------

    def s2_of(wd_counts: jax.Array) -> jax.Array:
        """S2 from a [..., 5, E] weekday x employee count matrix
        (ref :194-218); batched over any leading axes."""
        wd_present = wd_counts > 0
        n_present = jnp.sum(wd_present, axis=-1)
        min_present = jnp.min(
            jnp.where(wd_present, wd_counts, jnp.inf), axis=-1
        )
        return jnp.sum(jnp.where(n_present > 1, min_present, 0.0), axis=-1)

    def spread_of(v: jax.Array, present: jax.Array, n_pres: jax.Array):
        """Max-min spread of ``v`` [..., E] over a fixed present mask [E]."""
        mx = jnp.max(jnp.where(present, v, -jnp.inf), axis=-1)
        mn = jnp.min(jnp.where(present, v, jnp.inf), axis=-1)
        return jnp.where(n_pres >= 2, mx - mn, 0.0)

    def s34_of(tot: jax.Array, wk: jax.Array) -> jax.Array:
        """S3 + S4 spreads; 'present' = employees with >= 1 total day for
        BOTH spreads (the reference iterates employees_to_days keys,
        ref :344-365)."""
        present = tot > 0
        n_pres = jnp.sum(present)
        spread = lambda v: jnp.where(
            n_pres >= 2,
            jnp.max(jnp.where(present, v, -jnp.inf))
            - jnp.min(jnp.where(present, v, jnp.inf)),
            0.0,
        )
        return spread(tot) + spread(wk)

    def score(assign: jax.Array) -> jax.Array:
        oh = jax.nn.one_hot(assign, n_emp, dtype=f32)  # [D, E]

        # H1 — holidays (ref :272-280); one-hot contraction, not a gather.
        h1 = jnp.sum(oh * holiday.T.astype(f32))

        # H2 — consecutive days (ref :285-292).
        h2 = jnp.sum(assign[:-1] == assign[1:]) if d_days >= 2 else 0

        # H3 — consecutive weekends, windows(9) (ref :294-315).
        if d_days >= 9:
            a = assign
            cond = weekend[: d_days - 8] & weekend[1 : d_days - 7]
            e17 = a[: d_days - 8] == a[7 : d_days - 1]
            e18 = a[: d_days - 8] == a[8:d_days]
            e27 = a[1 : d_days - 7] == a[7 : d_days - 1]
            e28 = a[1 : d_days - 7] == a[8:d_days]
            h3 = jnp.sum(
                jnp.where(cond, e17.astype(f32) + e18 + e27 + e28, 0.0)
            )
        else:
            h3 = 0.0

        # Prefix sums for windowed counts (H4/S1): C[i] = counts in days [0, i).
        csum = jnp.concatenate(
            [jnp.zeros((1, n_emp), f32), jnp.cumsum(oh, axis=0)], axis=0
        )  # [D+1, E]

        # H4 — > 3 shifts per 14-day window (ref :317-327).
        if d_days >= 14:
            win14 = csum[14:] - csum[:-14]  # [D-13, E]
            h4 = jnp.sum(win14 > 3)
        else:
            h4 = 0

        # S1 — > 2 shifts per 7-day window (ref :329-339).
        if d_days >= 7:
            win7 = csum[7:] - csum[:-7]
            s1 = jnp.sum(win7 > 2)
        else:
            s1 = 0

        # S2 — weekday consistency Mon-Fri (ref :194-218, :341-342).
        s2 = s2_of(wd_onehot @ oh)

        # S3/S4 — max-min spreads (ref :344-365).
        tot = jnp.sum(oh, axis=0)  # [E]
        wk = jnp.sum(oh * weekend[:, None], axis=0)
        s34 = s34_of(tot, wk)

        hard = h1 + h2 + h3 + h4
        soft = s1 + s2 + s34
        return make_score(hard.astype(f32), soft.astype(f32))

    def init(key):
        # Uniform random employee per day (ref :404-419).
        return jax.random.randint(key, (d_days,), 0, n_emp, jnp.int32)

    def is_best(s):
        return (s[0] == 0) & (s[1] == 0)

    def fingerprint(assign):
        return fingerprint_i32(assign)

    # -- move sampling (shared by the delta and rescore paths) -------------

    def sample_moves(key):
        return sample_random_moves(key, w_size, d_days, n_emp)

    def resolve_move(assign, move):
        """A move as two (day, old_emp -> new_emp) point changes.  For
        ChangeDay the second change is the identity (n2 == e2), so every
        downstream +-1 one-hot difference vanishes without branching."""
        is_swap, d1, d2, new_emp = move
        e1 = jax.lax.dynamic_index_in_dim(assign, d1, keepdims=False)
        e2 = jax.lax.dynamic_index_in_dim(assign, d2, keepdims=False)
        n1 = jnp.where(is_swap, e2, new_emp)
        n2 = jnp.where(is_swap, e1, e2)
        return d1, e1, n1, d2, e2, n2

    # -- delta evaluation ---------------------------------------------------

    # Static-shift matrix of the padded weekend table for gather-free region
    # slices: wk_shift[r, d] = wk_pad[d + r] (see exact_move_deltas).
    wk_shift_f = jnp.stack(
        [wk_pad[r : r + d_days].astype(jnp.float32) for r in range(REG)]
    )  # f32[REG, D]

    def exact_move_deltas(assign, moves):
        """Exact (d_hard f32[W], d_soft f32[W], fp_deltas uint32[W, 2]) for
        W arbitrary ChangeDay/SwapDays moves — ANY day pair, including
        overlapping 27-day regions — via the region-delta path.  Shared by
        the random/delta proposer and the dense block's unrestricted
        random-swap extension (close-pair swaps are not reachable through
        the window-disjoint swap diagonals)."""
        is_swap, d1, d2, new_emp = moves

        # Base aggregates, once per call (O(D·E), amortized over W).
        oh = jax.nn.one_hot(assign, n_emp, dtype=f32)  # [D, E]
        wd_counts = wd_onehot @ oh                     # [5, E]
        tot = jnp.sum(oh, axis=0)                      # [E]
        wk = jnp.sum(oh * weekend_f[:, None], axis=0)  # [E]
        s2_base = s2_of(wd_counts)
        s34_base = s34_of(tot, wk)
        a_pad = jnp.concatenate(
            [
                jnp.full((PAD,), -1, jnp.int32),
                assign,
                jnp.full((PAD,), -1, jnp.int32),
            ]
        )

        # Per-move day lookups as one-hot contractions over the day axis —
        # vectorized over all W moves at once, no random gathers on device.
        iota_d = jnp.arange(d_days, dtype=jnp.int32)[None, :]
        at_d1 = (iota_d == d1[:, None]).astype(f32)  # [W, D]
        at_d2 = (iota_d == d2[:, None]).astype(f32)
        lookup = lambda at, tbl: jnp.sum(at * tbl[None, :], axis=1)
        e1 = lookup(at_d1, assign.astype(f32)).astype(jnp.int32)  # [W]
        e2 = lookup(at_d2, assign.astype(f32)).astype(jnp.int32)
        n1 = jnp.where(is_swap, e2, new_emp)
        n2 = jnp.where(is_swap, e1, e2)  # identity for ChangeDay
        hol1 = at_d1 @ holiday_de  # [W, E]
        hol2 = at_d2 @ holiday_de
        wd1 = lookup(at_d1, weekday.astype(f32)).astype(jnp.int32)
        wd2 = lookup(at_d2, weekday.astype(f32)).astype(jnp.int32)
        wk1 = lookup(at_d1, weekend_f)
        wk2 = lookup(at_d2, weekend_f)

        # 27-day region slices for ALL moves as shift-matrix contractions:
        # sl[w, r] = a_pad[d_w + r].  A vmapped dynamic_slice batches the
        # starts and lowers to a gather (which serialized on the hardware
        # this was written for; not yet measured on the H100); the
        # [W, D] x [REG, D] einsum is one small matmul.
        a_shift_f = jnp.stack(
            [
                jax.lax.slice_in_dim(a_pad, r, r + d_days).astype(f32)
                for r in range(REG)
            ]
        )  # f32[REG, D], values in {-2, -1, 0..E-1} (exact in f32)
        sl1 = jnp.einsum("wd,rd->wr", at_d1, a_shift_f).astype(jnp.int32)
        sl2 = jnp.einsum("wd,rd->wr", at_d2, a_shift_f).astype(jnp.int32)
        wk_sl1 = jnp.einsum("wd,rd->wr", at_d1, wk_shift_f) > 0.5
        wk_sl2 = jnp.einsum("wd,rd->wr", at_d2, wk_shift_f) > 0.5

        def delta_one(d1, n1, d2, n2, e1, e2, hol1, hol2, wd1, wd2, wk1, wk2,
                      sl1, sl2, wk_sl1, wk_sl2):
            oh1 = jax.nn.one_hot(n1, n_emp, dtype=f32) - jax.nn.one_hot(
                e1, n_emp, dtype=f32
            )
            oh2 = jax.nn.one_hot(n2, n_emp, dtype=f32) - jax.nn.one_hot(
                e2, n_emp, dtype=f32
            )

            # Windowed families (H2/H3/H4, S1) around each changed day.
            dh_a, ds1_a = region_deltas(
                sl1, wk_sl1, d1, n1, d2, n2, e1, e2, d1, d2, False, d_days
            )
            dh_b, ds1_b = region_deltas(
                sl2, wk_sl2, d1, n1, d2, n2, e1, e2, d2, d1, True, d_days
            )

            # H1 — holiday rows of the changed days.
            d_h1 = jnp.sum(hol1 * oh1) + jnp.sum(hol2 * oh2)

            # S2 — +-1 updates to the [5, E] weekday counts.
            upd = (
                wd_counts
                + jax.nn.one_hot(wd1, 5, dtype=f32)[:, None] * oh1[None, :]
                + jax.nn.one_hot(wd2, 5, dtype=f32)[:, None] * oh2[None, :]
            )
            d_s2 = s2_of(upd) - s2_base

            # S3/S4 — +-1 updates to totals and weekend totals.
            tot_new = tot + oh1 + oh2
            wk_new = wk + wk1 * oh1 + wk2 * oh2
            d_s34 = s34_of(tot_new, wk_new) - s34_base

            return d_h1 + dh_a + dh_b, ds1_a + ds1_b + d_s2 + d_s34

        d_hard, d_soft = jax.vmap(delta_one)(
            d1, n1, d2, n2, e1, e2, hol1, hol2, wd1, wd2, wk1, wk2,
            sl1, sl2, wk_sl1, wk_sl2,
        )
        fpd = _swap_fp_delta_planes(d1, e1, n1, d2, e2, n2)
        return d_hard, d_soft, fpd

    def neighborhood(assign, cur_score, key):
        moves = sample_moves(key)
        d_hard, d_soft, fpd = exact_move_deltas(assign, moves)
        scores = cur_score[None, :] + jnp.stack([d_hard, d_soft], axis=1)
        valid = jnp.ones((w_size,), bool)
        return Neighborhood(
            scores=scores, moves=moves, valid=valid,
            fp_deltas=jnp.stack(fpd, axis=-1),
        )

    # -- dense-block neighborhood (the device hot path) ---------------------

    n_off = n_swap_offsets if d_days >= 15 else 0
    n_rand = n_rand_swaps if d_days >= 2 else 0

    def _shf(x, k, fill):
        """y[d] = x[d + k] with out-of-range filled (static k)."""
        if k == 0:
            return x
        if abs(k) >= x.shape[0]:
            return jnp.full(x.shape, fill, x.dtype)
        pad = jnp.full((abs(k),) + x.shape[1:], fill, x.dtype)
        return (
            jnp.concatenate([x[k:], pad]) if k > 0
            else jnp.concatenate([pad, x[:k]])
        )

    # Banded 0/1 window matrices: per-window employee counts and the
    # windows-containing-day aggregation become single small matmuls, in
    # place of a cumsum formulation (reduce-window) that was slower on the
    # hardware this was written for; not yet measured on the H100.
    _band = {}
    for _w in (7, 14):
        if d_days >= _w:
            _s = np.arange(d_days - _w + 1)[:, None]
            _d = np.arange(d_days)[None, :]
            _band[_w] = jnp.asarray(
                ((_s <= _d) & (_d < _s + _w)).astype(np.float32)
            )  # [n_win, D]: window s contains day d

    def neighborhood_dense(assign, cur_score, key):
        """All D x E ChangeDay deltas as one dense block + n_off SwapDays
        diagonals.  Every constraint family's delta is exact (see module
        docstring); candidates equal to the current assignment get delta 0.
        """
        a = assign
        oh = jax.nn.one_hot(a, n_emp, dtype=f32)      # [D, E]
        iota_d = jnp.arange(d_days, dtype=jnp.int32)
        iota_e = jnp.arange(n_emp, dtype=jnp.int32)

        # ---- H1: holiday row minus the current day's holiday flag.
        h1_old = jnp.sum(holiday_de * oh, axis=1)     # [D]
        d_h1 = holiday_de - h1_old[:, None]           # [D, E]

        # ---- H2: the two adjacent pairs of each day.
        aL, aR = _shf(a, -1, -2), _shf(a, 1, -3)
        mL = (iota_d >= 1).astype(f32)
        mR = (iota_d <= d_days - 2).astype(f32)
        old2 = mL * (aL == a) + mR * (a == aR)        # [D]
        new2 = (
            mL[:, None] * (aL[:, None] == iota_e[None, :])
            + mR[:, None] * (aR[:, None] == iota_e[None, :])
        )
        d_h2 = new2 - old2[:, None]                   # [D, E]

        # ---- H3: the four windows where day d sits at position 0/1/7/8.
        cond = weekend & _shf(weekend, 1, False)      # [D] at window start w
        pairs = ((0, 7), (0, 8), (1, 7), (1, 8))
        eq = lambda i, j: (_shf(a, i, -2) == _shf(a, j, -3)).astype(f32)
        old3 = eq(0, 7) + eq(0, 8) + eq(1, 7) + eq(1, 8)  # [D] at start w
        d_h3 = jnp.zeros((d_days, n_emp), f32)
        for p in (0, 1, 7, 8):
            # window start w = d - p; valid iff 0 <= w <= D-9.
            m_p = (
                (iota_d >= p) & (iota_d <= d_days - 9 + p)
            ).astype(f32) * _shf(cond, -p, False)
            new_p = jnp.zeros((d_days, n_emp), f32)
            for (i, j) in pairs:
                if i == p:
                    new_p += (
                        _shf(a, j - p, -2)[:, None] == iota_e[None, :]
                    ).astype(f32)
                elif j == p:
                    new_p += (
                        _shf(a, i - p, -2)[:, None] == iota_e[None, :]
                    ).astype(f32)
                else:
                    new_p += (
                        _shf(a, i - p, -2) == _shf(a, j - p, -3)
                    ).astype(f32)[:, None]
            d_h3 += m_p[:, None] * (new_p - _shf(old3, -p, 0.0)[:, None])

        # ---- H4 / S1: crossing counters.  +1 on employee e flips a window
        # iff its count is exactly at the threshold; -1 on the old employee
        # iff it is one above.  Banded matmuls (see _band) count each
        # window and aggregate the flips over the windows containing each
        # day.
        def crossings(width, thresh):
            if d_days < width:
                z = jnp.zeros((d_days, n_emp), f32)
                return z, z
            band = _band[width]
            cnt = band @ oh                            # [D-width+1, E]
            sp = band.T @ (cnt == thresh).astype(f32)  # [D, E]
            sm = band.T @ (cnt == thresh + 1).astype(f32)
            return sp, sm                              # both [D, E]

        sp14, sm14 = crossings(14, 3)
        sp7, sm7 = crossings(7, 2)
        d_h4 = sp14 - jnp.sum(sm14 * oh, axis=1)[:, None]
        d_s1 = sp7 - jnp.sum(sm7 * oh, axis=1)[:, None]

        # ---- S2: per-day first/second-minimum trick on the weekday row.
        iswd = (weekday < 5)
        wd_oh5 = jax.nn.one_hot(weekday, 5, dtype=f32)  # [D, 5] (0 on weekends)
        c_base = wd_onehot @ oh                          # [5, E]
        row_present = c_base > 0
        row_np = jnp.sum(row_present, axis=1)
        row_min = jnp.min(jnp.where(row_present, c_base, jnp.inf), axis=1)
        row_score = jnp.where(row_np > 1, row_min, 0.0)  # [5]
        s2_base = jnp.sum(row_score)
        old_rs = wd_oh5 @ row_score                      # [D]
        big = jnp.float32(1e9)
        v2 = wd_oh5 @ c_base - oh * iswd[:, None].astype(f32)  # [D, E]
        p2 = v2 > 0
        np2 = jnp.sum(p2, axis=1)                        # [D]
        v2m = jnp.where(p2, v2, big)
        min1 = jnp.min(v2m, axis=1)
        arg1 = jnp.argmin(v2m, axis=1)
        min2 = jnp.min(
            jnp.where(iota_e[None, :] == arg1[:, None], big, v2m), axis=1
        )
        cand2 = v2 + 1.0
        min_new = jnp.where(
            iota_e[None, :] == arg1[:, None],
            jnp.minimum(cand2, min2[:, None]),
            jnp.minimum(min1[:, None], cand2),
        )
        np_new2 = np2[:, None] + (v2 == 0)
        rs_new = jnp.where(np_new2 > 1, min_new, 0.0)
        d_s2 = iswd[:, None].astype(f32) * (rs_new - old_rs[:, None])

        # ---- S3/S4: per-day extrema tricks on totals / weekend totals.
        tot = jnp.sum(oh, axis=0)                        # [E]
        wk = jnp.sum(oh * weekend_f[:, None], axis=0)    # [E]
        pres_b = tot > 0
        np_b = jnp.sum(pres_b)
        s3_base = spread_of(tot, pres_b, np_b)
        s4_base = spread_of(wk, pres_b, np_b)

        v3 = tot[None, :] - oh                           # [D, E]
        p3 = v3 > 0
        np3 = jnp.sum(p3, axis=1)
        v3m = jnp.where(p3, v3, big)
        min1_3 = jnp.min(v3m, axis=1)
        arg1_3 = jnp.argmin(v3m, axis=1)
        min2_3 = jnp.min(
            jnp.where(iota_e[None, :] == arg1_3[:, None], big, v3m), axis=1
        )
        max1_3 = jnp.max(jnp.where(p3, v3, -big), axis=1)
        cand3 = v3 + 1.0
        min_new3 = jnp.where(
            iota_e[None, :] == arg1_3[:, None],
            jnp.minimum(cand3, min2_3[:, None]),
            jnp.minimum(min1_3[:, None], cand3),
        )
        max_new3 = jnp.maximum(max1_3[:, None], cand3)
        np_new3 = np3[:, None] + (v3 == 0)
        d_s3 = jnp.where(np_new3 >= 2, max_new3 - min_new3, 0.0) - s3_base

        v4 = wk[None, :] - weekend_f[:, None] * oh       # [D, E]
        v4m = jnp.where(p3, v4, big)
        min1_4 = jnp.min(v4m, axis=1)
        arg1_4 = jnp.argmin(v4m, axis=1)
        min2_4 = jnp.min(
            jnp.where(iota_e[None, :] == arg1_4[:, None], big, v4m), axis=1
        )
        v4M = jnp.where(p3, v4, -big)
        max1_4 = jnp.max(v4M, axis=1)
        argx_4 = jnp.argmax(v4M, axis=1)
        max2_4 = jnp.max(
            jnp.where(iota_e[None, :] == argx_4[:, None], -big, v4M), axis=1
        )
        cand4 = v4 + weekend_f[:, None]
        min_new4 = jnp.where(
            iota_e[None, :] == arg1_4[:, None],
            jnp.minimum(cand4, min2_4[:, None]),
            jnp.minimum(min1_4[:, None], cand4),
        )
        max_new4 = jnp.where(
            iota_e[None, :] == argx_4[:, None],
            jnp.maximum(cand4, max2_4[:, None]),
            jnp.maximum(max1_4[:, None], cand4),
        )
        d_s4 = jnp.where(np_new3 >= 2, max_new4 - min_new4, 0.0) - s4_base

        d_hard = d_h1 + d_h2 + d_h3 + d_h4               # [D, E]
        d_soft = d_s1 + d_s2 + d_s3 + d_s4
        # e == a[d] is the identity move: exact delta 0.
        noop = oh > 0
        d_hard = jnp.where(noop, 0.0, d_hard)
        d_soft = jnp.where(noop, 0.0, d_soft)

        # ---- SwapDays diagonals: swap(d, d+delta), delta ~ U[14, D).
        # Window-disjoint (delta >= 14), so windowed deltas decompose into
        # the two ChangeDay deltas above; S2/S4 are re-derived coupled
        # (S3 is zero: totals are permutation-invariant).
        ch_moves = (
            jnp.zeros((d_days * n_emp,), bool),
            jnp.repeat(iota_d, n_emp),
            jnp.repeat(iota_d, n_emp),
            jnp.tile(iota_e, d_days),
        )
        ch_scores = (
            cur_score[0] + d_hard.reshape(-1),
            cur_score[1] + d_soft.reshape(-1),
        )
        ch_valid = jnp.ones((d_days * n_emp,), bool)
        # Dense batch fingerprints: fp' = fp ^ h(d, a[d]) ^ h(d, e) — one
        # [D, E] XOR per lane plane against the precomputed h(d, e) table,
        # enabling the reference-exact tabu filter at negligible cost (the
        # pick-then-check retry budget exhausted on >50% of soft-phase
        # iterations on this block, stalling the descent).
        h_old0, h_old1 = position_hash_planes(iota_d, a.astype(jnp.uint32))
        ch_fpd = (
            (h_old0[:, None] ^ h_de0).reshape(-1),
            (h_old1[:, None] ^ h_de1).reshape(-1),
        )
        blocks = [(ch_scores, ch_moves, ch_valid, ch_fpd)]
        k_off, k_rs = jax.random.split(key)

        if n_rand > 0:
            # Unrestricted random swaps: ANY day pair, exact overlapping-
            # window deltas via the region path.  Close-pair swaps matter —
            # they rearrange days inside one constraint window without
            # touching per-employee totals, the move class the window-
            # disjoint diagonals below cannot express (the W=100 random
            # proposer descends the soft score in ~3x fewer rounds than the
            # diagonal-only dense block on 365d x 20e).
            k_rs1, k_rs2 = jax.random.split(k_rs)
            rs_d1 = jax.random.randint(k_rs1, (n_rand,), 0, d_days, jnp.int32)
            rs_off = jax.random.randint(k_rs2, (n_rand,), 1, d_days, jnp.int32)
            rs_d2 = ((rs_d1 + rs_off) % d_days).astype(jnp.int32)
            rs_moves = (
                jnp.ones((n_rand,), bool),
                rs_d1,
                rs_d2,
                jnp.zeros((n_rand,), jnp.int32),
            )
            rs_dh, rs_ds, rs_fpd = exact_move_deltas(a, rs_moves)
            rs_scores = (cur_score[0] + rs_dh, cur_score[1] + rs_ds)
            blocks.append(
                (rs_scores, rs_moves, jnp.ones((n_rand,), bool), rs_fpd)
            )

        if n_off == 0:
            return _cat_blocks(blocks)

        delta = jax.random.randint(k_off, (n_off,), 14, d_days, jnp.int32)
        a_ext = jnp.concatenate([a, jnp.full((d_days,), -2, jnp.int32)])
        blk = jnp.concatenate([d_hard[None], d_s1[None]])          # [2, D, E]
        blk_ext = jnp.concatenate(
            [blk, jnp.zeros((2, d_days, n_emp), f32)], axis=1
        )

        # STATIC unroll over the n_off offsets: a vmapped dynamic_slice
        # batches the starts and lowers to a gather, which serialized on
        # the hardware this was written for; per-offset contiguous dynamic
        # slices avoid it.  Not yet measured on the H100.
        def one_diagonal(delta_j):
            a2 = jax.lax.dynamic_slice(a_ext, (delta_j,), (d_days,))  # [D]
            oh2 = jax.nn.one_hot(a2, n_emp, dtype=f32)                # [D, E]
            blk_sh = jax.lax.dynamic_slice(
                blk_ext, (0, delta_j, 0), (2, d_days, n_emp)
            )                                                          # [2,D,E]
            # Hard + S1 contractions of the ChangeDay blocks.
            term_a = jnp.einsum("kde,de->kd", blk, oh2)    # block[d, a2]
            term_b = jnp.einsum("kde,de->kd", blk_sh, oh)  # block[d+dlt, a1]
            hard_sw = term_a[0] + term_b[0]                # [D]
            s1_sw = term_a[1] + term_b[1]

            # S2 coupled: rows wd(d) and wd(d+delta) exchange a1 <-> a2.
            wd2 = (weekday + delta_j) % 7                  # [D]
            wd2_oh5 = jax.nn.one_hot(wd2, 5, dtype=f32)    # [D, 5]
            diff = oh2 - oh                                # +a2 -a1 at day d
            upd = (
                c_base[None]
                + wd_oh5[:, :, None] * diff[:, None, :]
                - wd2_oh5[:, :, None] * diff[:, None, :]
            )                                              # [D, 5, E]
            s2_sw = s2_of(upd) - s2_base                   # [D]

            # S4 coupled: wk[a2] += wkd1 - wkd2, wk[a1] -= wkd1 - wkd2.
            wkd2 = (wd2 >= 5).astype(f32)                  # [D]
            dw = (weekend_f - wkd2)[:, None]               # [D, 1]
            wk_new = wk[None, :] + dw * diff               # [D, E]
            s4_sw = spread_of(wk_new, pres_b, np_b) - s4_base

            noop_sw = a2 == a
            hard_j = jnp.where(noop_sw, 0.0, hard_sw)
            soft_j = jnp.where(noop_sw, 0.0, s1_sw + s2_sw + s4_sw)
            return hard_j, soft_j, a2

        parts = [one_diagonal(delta[j]) for j in range(n_off)]
        hard_sw = jnp.stack([p[0] for p in parts])         # [n_off, D]
        soft_sw = jnp.stack([p[1] for p in parts])
        a2 = jnp.stack([p[2] for p in parts])
        valid_sw = (iota_d[None, :] + delta[:, None]) <= d_days - 1

        d2_sw = jnp.minimum(iota_d[None, :] + delta[:, None], d_days - 1)
        sw_moves = (
            jnp.ones((n_off * d_days,), bool),
            jnp.tile(iota_d, n_off),
            d2_sw.reshape(-1).astype(jnp.int32),
            jnp.zeros((n_off * d_days,), jnp.int32),
        )
        sw_scores = (
            cur_score[0] + hard_sw.reshape(-1),
            cur_score[1] + soft_sw.reshape(-1),
        )
        d1_b = jnp.broadcast_to(iota_d[None, :], (n_off, d_days)).astype(
            jnp.int32
        )
        a_b = jnp.broadcast_to(a[None, :], (n_off, d_days))
        f0, f1 = _swap_fp_delta_planes(d1_b, a_b, a2, d2_sw, a2, a_b)
        sw_fpd = (f0.reshape(-1), f1.reshape(-1))
        blocks.append((sw_scores, sw_moves, valid_sw.reshape(-1), sw_fpd))
        return _cat_blocks(blocks)

    def materialize(assign, moves):
        """Candidate states [W, D] for the rescore A/B path — scatter-free
        mask writes, one row per move."""
        is_swap, d1, d2, new_emp = moves
        iota = jnp.arange(d_days, dtype=jnp.int32)[None, :]
        at_d1 = iota == d1[:, None]
        at_d2 = iota == d2[:, None]
        a1 = jnp.sum(jnp.where(at_d1, assign[None, :], 0), axis=1, keepdims=True)
        a2 = jnp.sum(jnp.where(at_d2, assign[None, :], 0), axis=1, keepdims=True)
        chg = jnp.where(at_d1, new_emp[:, None], assign[None, :])
        swp = jnp.where(at_d1, a2, jnp.where(at_d2, a1, assign[None, :]))
        return jnp.where(is_swap[:, None], swp, chg)  # [W, D]

    def neighborhood_rescore(assign, _cur_score, key):
        """Identical move sampling, O(D·E) full rescore per candidate.  Kept
        for the delta-vs-rescore A/B and as a property-test oracle."""
        moves = sample_moves(key)
        cands = materialize(assign, moves)
        scores = jax.vmap(score)(cands)  # [W, 2]
        valid = jnp.ones((w_size,), bool)
        # XOR identity: fp(cand) = fp(cur) ^ (fp(cur) ^ fp(cand)) — exactly
        # the incremental deltas of the "random" path, so the two proposers
        # stay bit-identical under the exact tabu filter.
        fpd = fingerprint_i32(assign)[None, :] ^ fingerprint_i32(cands)
        return Neighborhood(
            scores=scores, moves=moves, valid=valid, fp_deltas=fpd
        )

    def move_fp(assign, cur_fp, moves, idx):
        move = jax.tree.map(lambda a: a[idx], moves)
        d1, e1, n1, d2, e2, n2 = resolve_move(assign, move)
        fp = fp_update(cur_fp, d1, e1.astype(jnp.uint32), n1.astype(jnp.uint32))
        return fp_update(fp, d2, e2.astype(jnp.uint32), n2.astype(jnp.uint32))

    def apply_move(assign, moves, idx):
        move = jax.tree.map(lambda a: a[idx], moves)
        d1, _e1, n1, d2, _e2, n2 = resolve_move(assign, move)
        iota = jnp.arange(d_days, dtype=jnp.int32)
        return jnp.where(iota == d1, n1, jnp.where(iota == d2, n2, assign))

    # -- systematic proposer (full-state moves) -----------------------------

    def neighborhood_systematic(assign, _cur_score, _key):
        # Every day rotated through its E-1 successor employees.
        offs = jnp.arange(1, n_emp, dtype=jnp.int32)  # [E-1]
        day_idx = jnp.arange(d_days, dtype=jnp.int32)  # [D]
        new_vals = (assign[:, None] + offs[None, :]) % n_emp  # [D, E-1]
        day_onehot = day_idx[:, None, None] == day_idx[None, None, :]  # [D,1,D]
        cands = jnp.where(
            day_onehot, new_vals[:, :, None], assign[None, None, :]
        )  # [D, E-1, D]
        cands = cands.reshape(-1, d_days)
        scores = jax.vmap(score)(cands)
        valid = jnp.ones((cands.shape[0],), bool)
        return Neighborhood(scores=scores, moves=cands, valid=valid)

    def move_fp_states(_assign, _cur_fp, moves, idx):
        return fingerprint_i32(moves[idx])

    def apply_move_states(_assign, moves, idx):
        return moves[idx]

    if proposer == "systematic":
        nbr_fn, fp_fn, apply_fn = (
            neighborhood_systematic,
            move_fp_states,
            apply_move_states,
        )
        width = d_days * (n_emp - 1)
    elif proposer == "dense":
        nbr_fn = neighborhood_dense
        width = d_days * n_emp + n_off * d_days + n_rand
        fp_fn, apply_fn = move_fp, apply_move
    else:
        assert proposer in ("random", "rescore"), proposer
        nbr_fn = neighborhood if proposer == "random" else neighborhood_rescore
        fp_fn, apply_fn = move_fp, apply_move
        width = w_size

    return Problem(
        name=f"scheduling-{d_days}d-{n_emp}e",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=nbr_fn,
        move_fp=fp_fn,
        apply_move=apply_fn,
        perturb=_make_perturb(d_days, n_emp),
        width=width,
    )


def _make_perturb(d_days: int, n_emp: int):
    def perturb(assign, is_elite, key):
        # {ChangeDaysSubsetRandomly: 100, DoNothing: 10} (ref :572-579);
        # k ~ U[1, D/20] near elites else U[1, D/2] (ref :600-603).
        k_strat, k_n, k_u, k_emp = jax.random.split(key, 4)
        do_change = jax.random.uniform(k_strat) < (100.0 / 110.0)
        hi = jnp.where(is_elite, max(1, d_days // 20), max(1, d_days // 2))
        n_alter = jax.random.randint(k_n, (), 1, hi + 1)
        u = jax.random.uniform(k_u, (d_days,))
        kth = jax.lax.dynamic_index_in_dim(jnp.sort(u), n_alter - 1, keepdims=False)
        alter = u <= kth
        new_emp = jax.random.randint(k_emp, (d_days,), 0, n_emp, jnp.int32)
        return jnp.where(do_change & alter, new_emp, assign)

    return perturb
