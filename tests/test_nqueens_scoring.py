"""N-Queens scoring tests.

Fixtures from the reference's unit tests (examples/nqueens/src/lib.rs:89-120)
plus property tests: counter-based totals vs a naive O(n^2) pairwise scorer,
and delta-scored neighborhoods vs full rescore.
"""

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.models.nqueens import (
    build_state,
    col_scores,
    make_nqueens_problem,
    total_conflicts,
)


def naive_col_scores(rows: np.ndarray) -> np.ndarray:
    """Direct transcription of the reference get_col_scores semantics
    (examples/nqueens/src/lib.rs:74-87) as an independent oracle."""
    n = len(rows)
    result = np.zeros(n, np.int64)
    for c1 in range(n):
        for c2 in range(c1 + 1, n):
            rd = rows[c2] - rows[c1]
            cd = c2 - c1
            if rd == 0 or abs(rd) == abs(cd):
                result[c1] += 1
                result[c2] += 1
    return result


def test_all_same_row_fixture():
    rows = jnp.asarray([0, 0, 0, 0], jnp.int32)
    np.testing.assert_array_equal(np.asarray(col_scores(rows)), [3, 3, 3, 3])
    assert int(total_conflicts(rows)) == 12


def test_known_solution_fixture():
    rows = jnp.asarray([1, 3, 0, 2], jnp.int32)
    np.testing.assert_array_equal(np.asarray(col_scores(rows)), [0, 0, 0, 0])
    assert int(total_conflicts(rows)) == 0


def test_counter_scoring_matches_naive():
    rng = np.random.default_rng(5)
    for n in (4, 8, 13, 32):
        for _ in range(5):
            rows = rng.integers(0, n, size=n)
            expected = naive_col_scores(rows)
            got = np.asarray(col_scores(jnp.asarray(rows, jnp.int32)))
            np.testing.assert_array_equal(got, expected)
            assert int(total_conflicts(jnp.asarray(rows, jnp.int32))) == expected.sum()


def test_neighborhood_delta_matches_full_rescore():
    """Kernel-equivalence (SURVEY.md §4): every candidate's delta score must
    equal the full rescore of the move applied from scratch."""
    rng = np.random.default_rng(6)
    for n in (8, 24, 64):
        problem = make_nqueens_problem(n)
        for trial in range(3):
            rows = jnp.asarray(rng.integers(0, n, size=n), jnp.int32)
            state = build_state(rows)
            cur = problem.score(state)
            assert float(cur[0]) == int(total_conflicts(rows))
            nb = problem.neighborhood(state, cur, jax.random.key(trial))
            cols_mv, new_rows = nb.moves
            cand_scores = np.asarray(nb.scores)[:, 0]
            for i in range(cols_mv.shape[0]):
                applied = rows.at[int(cols_mv[i])].set(int(new_rows[i]))
                assert cand_scores[i] == int(total_conflicts(applied)), (
                    f"n={n} cand {i}: delta {cand_scores[i]} != full rescore"
                )


def test_move_fingerprints_match_full():
    n = 16
    problem = make_nqueens_problem(n)
    rows = jnp.asarray(np.random.default_rng(7).integers(0, n, size=n), jnp.int32)
    state = build_state(rows)
    cur_fp = problem.fingerprint(state)
    nb = problem.neighborhood(state, problem.score(state), jax.random.key(0))
    cols_mv, new_rows = nb.moves
    for i in range(0, cols_mv.shape[0], 7):
        applied = build_state(rows.at[int(cols_mv[i])].set(int(new_rows[i])))
        np.testing.assert_array_equal(
            np.asarray(problem.fingerprint(applied)),
            np.asarray(problem.move_fp(state, cur_fp, nb.moves, i)),
        )


def test_apply_move_incremental_counters_consistent():
    """apply_move's incremental counter/col-score updates must equal a
    from-scratch build_state of the resulting board."""
    rng = np.random.default_rng(11)
    for n in (8, 32):
        problem = make_nqueens_problem(n)
        rows = jnp.asarray(rng.integers(0, n, size=n), jnp.int32)
        state = build_state(rows)
        nb = problem.neighborhood(state, problem.score(state), jax.random.key(3))
        cols_mv, new_rows = nb.moves
        for i in range(0, cols_mv.shape[0], 5):
            got = problem.apply_move(state, nb.moves, i)
            want = build_state(
                rows.at[int(cols_mv[i])].set(int(new_rows[i]))
            )
            for leaf_got, leaf_want in zip(got, want):
                np.testing.assert_array_equal(
                    np.asarray(leaf_got), np.asarray(leaf_want)
                )


def test_neighborhood_only_conflicted_columns():
    """The proposer must only touch columns that currently have conflicts
    (ref lib.rs:182-187)."""
    n = 12
    problem = make_nqueens_problem(n)
    rng = np.random.default_rng(8)
    rows = jnp.asarray(rng.integers(0, n, size=n), jnp.int32)
    cs = np.asarray(col_scores(rows))
    state = build_state(rows)
    nb = problem.neighborhood(state, problem.score(state), jax.random.key(1))
    cols_mv, _ = nb.moves
    valid = np.asarray(nb.valid)
    touched = np.unique(np.asarray(cols_mv)[valid])
    assert all(cs[c] > 0 for c in touched)
