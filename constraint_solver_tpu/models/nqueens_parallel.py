"""Synchronous parallel min-conflicts for N-Queens (beyond-parity mode).

The reference (and our ILS engine) moves ONE queen per inner iteration —
a sequential descent of ~O(n) steps.  This module is the accelerator-first
alternative: every step scores the FULL [n, n] move matrix (every column x
every row) with the same O(1) delta algebra, then applies MANY moves at
once:

1. per-column best row via delta scores (one dense [n, n] block, the same
   slice algebra as models/nqueens.py);
2. damped acceptance: improving columns are applied independently with
   probability ``p_accept`` (synchronous parallel local search; damping
   breaks oscillations between interacting moves);
3. monotonicity fallback: if the combined step made the score worse
   (interacting moves), the step is replaced by the single best move —
   guaranteeing at least sequential min-conflicts progress;
4. counters are rebuilt once per STEP (not per move) with the one-hot
   reductions.

A solve takes O(log-ish) hundreds of steps instead of thousands of
single-move iterations, and each step is one dense kernel — this is the
configuration that maximizes time-to-zero-violations per chip.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.models.nqueens import (
    NQState,
    block_scores,
    build_state,
)
from constraint_solver_tpu.utils.seeding import seed_string_to_key


class PMCState(NamedTuple):
    state: NQState
    score: jax.Array   # float32[] total conflicts
    steps: jax.Array   # int32[]
    key: jax.Array


def _score_matrix(st: NQState, c: jax.Array | None = None) -> jax.Array:
    """[A, n] candidate scores for columns ``c`` (default: all n columns):
    score_matrix[j, r'] = total conflicts after moving column c_j's queen
    to row r'."""
    n = st.rows.shape[0]
    if c is None:
        c = jnp.arange(n, dtype=jnp.int32)
        r = st.rows
        removed = st.cs  # (rc[r]-1)+(dc-1)+(ac-1) per column == col score
    else:
        onehot = (c[:, None] == jnp.arange(n, dtype=jnp.int32)).astype(
            jnp.float32
        )
        r = jnp.sum(onehot * st.rows, axis=-1).astype(jnp.int32)
        removed = jnp.sum(onehot * st.cs, axis=-1)
    s = lambda cnt: jnp.sum(cnt * (cnt - 1))
    cur = (s(st.rc) + s(st.dc) + s(st.ac)).astype(jnp.float32)
    return block_scores(st.rc, st.dc, st.ac, c, r, removed, cur)[0]


def pmc_step(p_accept, sample_cols, carry: PMCState) -> PMCState:
    st = carry.state
    n = st.rows.shape[0]
    key, k_u, k_kcol, k_krow, k_gum = jax.random.split(carry.key, 5)

    if sample_cols is None:
        cols = jnp.arange(n, dtype=jnp.int32)            # all columns
        scores = _score_matrix(st)                       # [n, n]
    else:
        # Huge boards: Gumbel-sample A conflicted columns (weighted by
        # conflict count) so the score block stays [A, n].
        logits = jnp.where(st.cs > 0, jnp.log(st.cs + 1e-4), -jnp.inf)
        gum = jax.random.gumbel(k_gum, (n,))
        _, cols = jax.lax.top_k(logits + gum, sample_cols)
        cols = cols.astype(jnp.int32)
        scores = _score_matrix(st, cols)                 # [A, n]

    a = cols.shape[0]
    best_row = jnp.argmin(scores, axis=1).astype(jnp.int32)  # [A]
    best_score = jnp.min(scores, axis=1)                 # [A]
    improving = best_score < carry.score
    stuck = ~jnp.any(improving)

    # Damped parallel acceptance, materialized scatter-free: accepted
    # sampled columns overwrite their row via a one-hot contraction.
    u = jax.random.uniform(k_u, (a,))
    accept = improving & (u < p_accept)
    onehot = (cols[:, None] == jnp.arange(n, dtype=jnp.int32)) & accept[:, None]
    col_hit = jnp.any(onehot, axis=0)                    # [n]
    col_val = jnp.sum(
        onehot.astype(jnp.int32) * best_row[:, None], axis=0
    )  # [n] (columns are distinct, so at most one contribution)
    rows_par = jnp.where(col_hit, col_val, st.rows)

    # Fallback: the single globally best sampled move.
    j_best = jnp.argmin(best_score)
    rows_one = st.rows.at[cols[j_best]].set(best_row[j_best])

    # Plateau escape: no improving move anywhere — kick a random conflicted
    # column to a random row (the stochastic escape of classic
    # min-conflicts; without it the descent stalls at small plateaus).
    logits = jnp.where(st.cs > 0, 0.0, -jnp.inf)
    kick_col = jax.random.categorical(k_kcol, logits)
    kick_row = jax.random.randint(k_krow, (), 0, n, jnp.int32)
    rows_kick = st.rows.at[kick_col].set(kick_row)

    s = lambda cnt: jnp.sum(cnt * (cnt - 1))

    def rebuild(rows):
        st2 = build_state(rows)
        return st2, (s(st2.rc) + s(st2.dc) + s(st2.ac)).astype(jnp.float32)

    # Common path: the damped parallel step improves — one rebuild.  The
    # fallback (single best move) and the plateau kick live behind lax.cond
    # so their O(n^2) rebuilds only execute when actually needed.
    st_par, score_par = rebuild(rows_par)
    par_good = (~stuck) & (score_par < carry.score)

    def fallback(_):
        def kicked(_):
            return rebuild(rows_kick)

        def single(_):
            return rebuild(rows_one)

        return jax.lax.cond(stuck, kicked, single, None)

    new_state, new_score = jax.lax.cond(
        par_good, lambda _: (st_par, score_par), fallback, None
    )
    return PMCState(
        state=new_state, score=new_score, steps=carry.steps + 1, key=key
    )


@partial(jax.jit, static_argnames=("n",))
def pmc_init(n: int, key: jax.Array) -> PMCState:
    key, k_init = jax.random.split(key)
    st = build_state(
        jax.random.permutation(k_init, jnp.arange(n, dtype=jnp.int32))
    )
    s = lambda cnt: jnp.sum(cnt * (cnt - 1))
    score = (s(st.rc) + s(st.dc) + s(st.ac)).astype(jnp.float32)
    return PMCState(state=st, score=score, steps=jnp.int32(0), key=key)


@partial(jax.jit, static_argnames=("max_steps", "p_accept", "sample_cols"))
def pmc_run(
    carry: PMCState,
    max_steps: int,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
) -> PMCState:
    """Continue a solve for up to ``max_steps`` more steps (stops early at
    0 conflicts).  Chunk-friendly: re-invoke with the returned carry."""
    limit = carry.steps + max_steps

    def cond(c: PMCState):
        return (c.score > 0) & (c.steps < limit)

    return jax.lax.while_loop(
        cond, partial(pmc_step, p_accept, sample_cols), carry
    )


def pmc_solve(
    n: int,
    key: jax.Array,
    max_steps: int = 5000,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
) -> PMCState:
    """Solve n-queens by parallel min-conflicts from a random permutation.
    Stops at 0 conflicts or after ``max_steps`` (one device dispatch).
    ``sample_cols``: bound the per-step score block to [A, n] for huge
    boards (default: all n columns)."""
    carry = pmc_init(n, key)
    return pmc_run(carry, max_steps, p_accept, sample_cols)


class ParallelMinConflictsSolver:
    """Driver wrapper matching the Solver result surface."""

    def __init__(
        self,
        board_size: int,
        seed: str = "42",
        max_steps: int = 5000,
        p_accept: float = 0.7,
        population: int = 1,
        sample_cols: int | None = None,
    ):
        """``sample_cols``: bound each step's score block to [A, n] instead
        of the full [n, n] matrix, for huge boards."""
        self.n = board_size
        self.population = population
        # Per-step evaluated block width (for the moves metric).
        self._block = (sample_cols or board_size) * board_size
        key = seed_string_to_key(seed)
        if population == 1:
            self._out = pmc_solve(
                board_size, key, max_steps, p_accept, sample_cols
            )
        else:
            keys = jax.random.split(key, population)
            solve = partial(
                pmc_solve,
                board_size,
                max_steps=max_steps,
                p_accept=p_accept,
                sample_cols=sample_cols,
            )
            outs = jax.vmap(solve)(keys)
            lane = jnp.argmin(outs.score)
            self._out = jax.tree.map(lambda a: a[lane], outs)
            self._all_scores = outs.score

    def get_best_solution(self):
        out = self._out
        return (float(np.asarray(out.score)), 0.0), jax.tree.map(
            np.asarray, out.state
        )

    def stats(self) -> dict:
        # Each step evaluates an [A, n] move block (A = n without sampling).
        steps = int(np.asarray(self._out.steps))
        return {
            "steps": steps,
            "moves_evaluated": steps * self._block * max(1, self.population),
        }
