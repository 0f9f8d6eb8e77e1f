"""N-Queens domain with dense O(1)-delta neighborhood scoring.

Reference semantics (reference examples/nqueens/src/lib.rs):

- solution: one queen per column, ``rows[col] = row`` (ref lib.rs:18-23);
- score: total conflict count, counting each attacking pair **twice** (the
  per-column sum convention of ``get_col_scores``, ref lib.rs:74-87) —
  equal rows, equal diagonals, or equal anti-diagonals attack;
- is_best: score == 0 (ref lib.rs:66-71);
- neighborhood (ref lib.rs:173-256): sample conflicted columns weighted by
  conflict count without replacement (``choose_multiple_weighted``,
  ref lib.rs:196-201), draw ``num_cols ~ U[1, amount]``, and enumerate
  **every row value** for each chosen column;
- perturbation (ref lib.rs:285-320): w.p. 100/110 assign random rows to
  ``U[1, n/20]`` random columns if current is an elite else ``U[1, n/2]``
  (intensify/diversify), w.p. 10/110 do nothing.

Dense scoring: instead of the reference's O(n^2) pairwise rescan per
candidate clone (ref lib.rs:74-87 called per move), we maintain per-line
occupancy counters — row / diagonal / anti-diagonal — from which

    total_conflicts = sum over lines of k * (k - 1)

(equals the reference's x2-pair convention: rows/diags/antidiags partition
attacking pairs, each contributing C(k,2) pairs), and a change-value move
(col c: r -> r') re-scores in O(1):

    delta = -2 * [(rc[r]-1) + (dc[d]-1) + (ac[a]-1)]
            +2 * [(rc[r']-[r'==r]) + (dc[d']-[d'==d]) + (ac[a']-[a'==a])]

The whole [A, n] candidate block (A sampled columns x all n rows) is scored
as one fused elementwise tensor op (``block_scores``).

Weighted sampling without replacement is Gumbel-top-k (the exact
Plackett-Luce equivalent of successive weighted draws); see SURVEY.md §7
"hard parts" item 3.  Divergence note: the reference subsamples ``num_cols``
of its ``amount`` drawn columns uniquely; we take the first ``num_cols`` of
the Gumbel order (already a random weighted order) — same support, slightly
different inclusion probabilities.

Divergence note (neighborhood width): the reference truncates the proposed
move list to ``window_size`` = 5n candidates and stops scoring there
(ref examples/nqueens/src/main.rs:130, local_search.rs:321); this
neighborhood scores the full dense A x n block (50,000 candidates at the
bench's A=50, n=1000) because the block is one fused elementwise op —
masking it to 5n would save nothing.  Consequence for metrics: "moves
evaluated/s" counts ~10x more candidate evaluations per LS iteration than
the reference would score for the same descent, so cross-implementation
comparisons should anchor on time-to-zero-violations (bench.py reports
both).

The solver state ``NQState`` carries the line counters and per-column
conflict scores INCREMENTALLY: applying a move updates 6 counter entries
and does one O(n) elementwise fix-up of the column scores, so a local-search
iteration costs O(A x n) for the candidate block instead of O(n^2) counter
rebuilds.  Counters are rebuilt from scratch only on init/perturb/restart
(once per ILS round).
"""

from __future__ import annotations

from functools import lru_cache

from typing import NamedTuple

import jax
import jax.numpy as jnp

from constraint_solver_tpu.core.problem import Neighborhood, Problem
from constraint_solver_tpu.ops.fingerprint import fingerprint_i32, fp_update
from constraint_solver_tpu.ops.lex import make_score
from constraint_solver_tpu.ops.nqueens_pallas import nqueens_block_kernel


class NQState(NamedTuple):
    """N-Queens solver state: the board plus incrementally-maintained
    counters.  Solution identity (fingerprint/archive/tabu) is ``rows``
    alone; the rest is derived."""

    rows: jax.Array  # int32[n]
    rc: jax.Array    # float32[n]      row occupancy
    dc: jax.Array    # float32[2n-1]   diagonal occupancy (r - c + n-1)
    ac: jax.Array    # float32[2n-1]   anti-diagonal occupancy (r + c)
    cs: jax.Array    # float32[n]      per-column conflict counts


def line_counts(rows: jax.Array):
    """Occupancy counters (row_counts[n], diag_counts[2n-1], anti[2n-1]).

    One-hot-compare reductions, not scatter-adds: the [L, n] equality
    compare + sum fuses without materializing.  (Chosen where scatters with
    random 1D indices serialized; not yet compared with a scatter-add on the
    H100.)
    """
    n = rows.shape[-1]
    cols = jnp.arange(n, dtype=rows.dtype)
    f32 = jnp.float32
    iota_n = jnp.arange(n, dtype=rows.dtype)
    iota_l = jnp.arange(2 * n - 1, dtype=rows.dtype)
    d = rows - cols + (n - 1)
    a = rows + cols
    rc = jnp.sum((rows[None, :] == iota_n[:, None]).astype(f32), axis=-1)
    dc = jnp.sum((d[None, :] == iota_l[:, None]).astype(f32), axis=-1)
    ac = jnp.sum((a[None, :] == iota_l[:, None]).astype(f32), axis=-1)
    return rc, dc, ac


def _take_1d(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Vectorized gather table[idx] as a one-hot contraction (gather-free)."""
    iota = jnp.arange(table.shape[0], dtype=idx.dtype)
    onehot = (idx[..., None] == iota).astype(table.dtype)
    return jnp.sum(onehot * table, axis=-1)


def total_conflicts(rows: jax.Array) -> jax.Array:
    """Total conflict count, x2-pair convention (ref lib.rs:74-87 summed)."""
    rc, dc, ac = line_counts(rows)
    s = lambda c: jnp.sum(c * (c - 1))
    return (s(rc) + s(dc) + s(ac)).astype(jnp.int32)


def _col_scores_from_counts(rows, rc, dc, ac) -> jax.Array:
    """Per-column conflict counts from line counters: column c conflicts
    with (rc-1)+(dc-1)+(ac-1) others — the single definition of the
    per-column convention (ref lib.rs:74-87), shared by the oracle-tested
    ``col_scores`` and the solver-state ``cs``."""
    n = rows.shape[-1]
    cols = jnp.arange(n, dtype=rows.dtype)
    return (
        (_take_1d(rc, rows) - 1)
        + (_take_1d(dc, rows - cols + (n - 1)) - 1)
        + (_take_1d(ac, rows + cols) - 1)
    )


def col_scores(rows: jax.Array) -> jax.Array:
    """Per-column conflict counts, matching ``get_col_scores``
    (ref lib.rs:74-87)."""
    return _col_scores_from_counts(rows, *line_counts(rows)).astype(jnp.int32)


def build_state(rows: jax.Array) -> NQState:
    """Construct the full counter state from a bare board (O(n^2) one-hots;
    used at init / perturbation / restart, not in the inner loop)."""
    rc, dc, ac = line_counts(rows)
    cs = _col_scores_from_counts(rows, rc, dc, ac)
    return NQState(rows=rows, rc=rc, dc=dc, ac=ac, cs=cs)


def block_scores(rc, dc, ac, c, r, removed, cur):
    """Score the [A, n] candidate block: moving sampled column ``c[j]`` (now
    on row ``r[j]``, with ``removed[j]`` = (rc[r]-1)+(dc[d]-1)+(ac[a]-1)) to
    every row, from current total ``cur``.  Returns ``(scores float32[A, n],
    row_min float32[A], row_arg int32[A])`` with a first-index argmin."""
    n = rc.shape[0]
    f32 = jnp.float32
    rp = jnp.arange(n, dtype=jnp.int32)[None, :]  # [1, n] candidate rows
    # dc[rp - c_j + (n-1)] and ac[rp + c_j] are CONTIGUOUS slices of the
    # diagonal tables (length n, start n-1-c_j resp. c_j).
    dc_at = jax.vmap(
        lambda s: jax.lax.dynamic_slice(dc, (s,), (n,))
    )((n - 1) - c)  # [A, n]
    ac_at = jax.vmap(
        lambda s: jax.lax.dynamic_slice(ac, (s,), (n,))
    )(c)
    d = r - c + (n - 1)
    a = r + c
    dp = rp - c[:, None] + (n - 1)                # [A, n]
    ap = rp + c[:, None]
    added = (
        (rc[None, :] - (rp == r[:, None]))
        + (dc_at - (dp == d[:, None]))
        + (ac_at - (ap == a[:, None]))
    )  # [A, n]
    delta = 2 * (added - removed[:, None])
    scores = cur + delta.astype(f32)  # [A, n]
    row_min = jnp.min(scores, axis=1)
    row_arg = jnp.argmax(scores == row_min[:, None], axis=1).astype(jnp.int32)
    return scores, row_min, row_arg


@lru_cache(maxsize=32)
def make_nqueens_problem(
    board_size: int,
    sample_cols: int | None = None,
    nbr_axis: str | None = None,
    nbr_shards: int = 1,
    nbr_keep: int = 64,
    col_sampling: str = "exact",
) -> Problem:
    """Build the N-Queens problem.  ``sample_cols`` (A) is the number of
    conflicted columns sampled per proposal; default ``max(1, n // 20)``
    mirrors the reference's ``amount`` cap (ref lib.rs:196).

    ``nbr_axis``/``nbr_shards``: tensor-parallel neighborhood.  Inside a
    ``shard_map`` over that mesh axis, each shard scores A/shards of the
    sampled columns, keeps its ``nbr_keep`` best candidates, and an
    all_gather rebuilds a small global candidate list — the engine is
    oblivious.  The Gumbel column sample is computed identically on every
    shard (replicated state, same key), so shards stay consistent.

    The [A, n] block runs the Triton-route Pallas kernel
    (ops/nqueens_pallas.py) when JAX's backend is a GPU -- it beat the XLA
    slice path end to end on the H100 (PERF.md) -- and ``block_scores``
    everywhere else."""
    n = board_size
    use_kernel = jax.default_backend() == "gpu"
    a_max = sample_cols if sample_cols is not None else max(1, n // 20)
    if nbr_axis is not None:
        # Pad A up so every shard gets an equal slice.
        a_max = ((a_max + nbr_shards - 1) // nbr_shards) * nbr_shards
    a_local = a_max // nbr_shards

    def init(key):
        # Random permutation start (ref lib.rs:152-161).
        return build_state(
            jax.random.permutation(key, jnp.arange(n, dtype=jnp.int32))
        )

    def score(state):
        s = lambda c: jnp.sum(c * (c - 1))
        return make_score(s(state.rc) + s(state.dc) + s(state.ac))

    def is_best(s):
        return s[0] == 0

    def fingerprint(state):
        return fingerprint_i32(state.rows)

    def neighborhood(state, cur_score, key):
        rows, rc, dc, ac, cs = state
        k_gumbel, k_num = jax.random.split(key)
        conflicted = cs > 0
        n_conflicted = jnp.sum(conflicted)

        # Weighted sample of A columns without replacement via Gumbel-top-k
        # (weights = conflict count + 1e-4, ref lib.rs:198).
        logits = jnp.log(cs.astype(jnp.float32) + 1e-4)
        logits = jnp.where(conflicted, logits, -jnp.inf)
        gumbel = jax.random.gumbel(k_gumbel, (n,))
        if col_sampling == "approx":
            # approx_max_k skips the exact partial sort; recall ~0.95
            # slightly perturbs Gumbel inclusion
            # probabilities, the same divergence class as the Gumbel
            # sampling itself (docstring note above).  Deterministic.
            _, chosen_cols = jax.lax.approx_max_k(logits + gumbel, a_max)
        else:
            _, chosen_cols = jax.lax.top_k(logits + gumbel, a_max)  # [A]

        # amount = clamp(n/20, 1, #conflicted); num_cols ~ U[1, amount]
        # (ref lib.rs:196-203).
        amount = jnp.clip(n_conflicted, 1, a_max)
        num_cols = jax.random.randint(k_num, (), 1, amount + 1)
        col_valid = jnp.arange(a_max) < jnp.minimum(num_cols, n_conflicted)

        c = chosen_cols.astype(jnp.int32)            # [A]
        if nbr_axis is not None:
            # Tensor-parallel: this shard scores its A/shards column slice.
            shard = jax.lax.axis_index(nbr_axis)
            c = jax.lax.dynamic_slice(c, (shard * a_local,), (a_local,))
            col_valid = jax.lax.dynamic_slice(
                col_valid, (shard * a_local,), (a_local,)
            )
        r = _take_1d(rows.astype(jnp.float32), c).astype(jnp.int32)  # [A]
        d = r - c + (n - 1)
        a = r + c

        # Remove the queen from its lines: each line loses 2*(k-1).
        removed = (
            (_take_1d(rc, r) - 1) + (_take_1d(dc, d) - 1) + (_take_1d(ac, a) - 1)
        )  # [A]

        rp = jnp.arange(n, dtype=jnp.int32)[None, :]  # [1, n] candidate rows
        if use_kernel:
            cand_hard, row_min, row_arg = nqueens_block_kernel(
                rc, dc, ac, c, r, removed, cur_score[0],
            )
        else:
            cand_hard, row_min, row_arg = block_scores(
                rc, dc, ac, c, r, removed, cur_score[0]
            )
        a_here = c.shape[0]
        hard_flat = cand_hard.reshape(-1)
        mv_cols = jnp.broadcast_to(c[:, None], (a_here, n)).reshape(-1)
        mv_rows = jnp.broadcast_to(rp, (a_here, n)).reshape(-1).astype(jnp.int32)
        valid = jnp.broadcast_to(col_valid[:, None], (a_here, n)).reshape(-1)

        # First-pick hint for the engine's tabu pick (Neighborhood.hint_idx):
        # the flat lex_argmin of the block, assembled from per-row minima in
        # O(A) instead of a full [A*n] reduction pass over HBM.  Exactness
        # (incl. first-index tie-breaking): per-row argmin takes the lowest
        # row among ties, and the cross-row argmin takes the lowest column
        # index among ties, which is exactly the lowest flat index.  The
        # soft channel is identically 0 here, so plain min == lex min.
        row_min_v = jnp.where(col_valid, row_min, jnp.inf)
        j_best = jnp.argmax(row_min_v == jnp.min(row_min_v)).astype(jnp.int32)
        hint_idx = j_best * n + row_arg[j_best]

        if nbr_axis is not None:
            # Local top-k then all_gather over the nbr axis: the engine sees
            # a small replicated candidate list instead of the sharded block.
            # No hint here — the gathered list is tiny, the engine's full
            # argmin over it is cheap.
            k_keep = min(nbr_keep, a_here * n)
            neg, idxs = jax.lax.top_k(
                jnp.where(valid, -hard_flat, -jnp.inf), k_keep
            )
            hard_flat = -neg
            mv_cols = mv_cols[idxs]
            mv_rows = mv_rows[idxs]
            valid = jnp.isfinite(hard_flat)
            gather = lambda x: jax.lax.all_gather(
                x, nbr_axis, axis=0, tiled=True
            )
            hard_flat = gather(hard_flat)
            mv_cols = gather(mv_cols)
            mv_rows = gather(mv_rows)
            valid = gather(valid)
            hint_idx = None

        scores = make_score(hard_flat)
        # Exact valid-count without a [A*n]-wide reduction: the mask is a
        # column mask broadcast over the n rows.
        n_valid = (
            None if nbr_axis is not None
            else jnp.sum(col_valid.astype(jnp.int32)) * n
        )
        return Neighborhood(
            scores=scores, moves=(mv_cols, mv_rows), valid=valid,
            hint_idx=hint_idx, n_valid=n_valid,
        )

    def move_fp(state, cur_fp, moves, idx):
        cols_mv, new_rows = moves
        col = cols_mv[idx]
        return fp_update(
            cur_fp,
            col,
            state.rows[col].astype(jnp.uint32),
            new_rows[idx].astype(jnp.uint32),
        )

    def apply_move(state, moves, idx):
        """Apply (col: r_old -> r_new) with O(1) counter updates and an
        O(n) elementwise column-score fix-up."""
        rows, rc, dc, ac, cs = state
        cols_mv, new_rows = moves
        col = cols_mv[idx]
        r_old = rows[col]
        r_new = new_rows[idx]
        d_old, d_new = r_old - col + (n - 1), r_new - col + (n - 1)
        a_old, a_new = r_old + col, r_new + col

        rows2 = rows.at[col].set(r_new)
        rc2 = rc.at[r_old].add(-1.0).at[r_new].add(1.0)
        dc2 = dc.at[d_old].add(-1.0).at[d_new].add(1.0)
        ac2 = ac.at[a_old].add(-1.0).at[a_new].add(1.0)

        # Column-score delta for every unchanged column: -1 per shared line
        # with the vacated (r_old, d_old, a_old), +1 per shared line with the
        # occupied (r_new, d_new, a_new).
        iota = jnp.arange(n, dtype=jnp.int32)
        dj = rows - iota + (n - 1)
        aj = rows + iota
        delta_cs = (
            (rows == r_new).astype(jnp.float32) - (rows == r_old)
            + (dj == d_new) - (dj == d_old)
            + (aj == a_new) - (aj == a_old)
        )
        cs2 = cs + delta_cs
        # The moved column's score is recomputed from the new counters.
        moved_cs = (rc2[r_new] - 1) + (dc2[d_new] - 1) + (ac2[a_new] - 1)
        cs2 = cs2.at[col].set(moved_cs)
        return NQState(rows=rows2, rc=rc2, dc=dc2, ac=ac2, cs=cs2)

    def perturb(state, is_elite, key):
        # {ChangeSubset: 100, DoNothing: 10} (ref lib.rs:274-283);
        # k ~ U[1, n/20] near elites else U[1, n/2] (ref lib.rs:304-307).
        k_strat, k_n, k_u, k_rows = jax.random.split(key, 4)
        do_change = jax.random.uniform(k_strat) < (100.0 / 110.0)
        hi = jnp.where(is_elite, max(1, n // 20), max(1, n // 2))
        n_alter = jax.random.randint(k_n, (), 1, hi + 1)
        # k random distinct positions, scatter-free: threshold the uniform
        # draw at its k-th order statistic.
        u = jax.random.uniform(k_u, (n,))
        kth = jax.lax.dynamic_index_in_dim(jnp.sort(u), n_alter - 1, keepdims=False)
        alter = u <= kth
        new_rows = jax.random.randint(k_rows, (n,), 0, n, jnp.int32)
        return build_state(jnp.where(do_change & alter, new_rows, state.rows))

    return Problem(
        name=f"nqueens-{n}",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=a_max * n,
    )
