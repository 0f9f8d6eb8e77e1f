"""N-Queens [A, n] block tests: the XLA path (models/nqueens.py
``block_scores``) and the Triton-route kernel (ops/nqueens_pallas.py, in
interpret mode on the CPU; compiled on a GPU by the ``gpu`` test).  Every
candidate score equals a naive full rescore, and the row min/argmin
byproducts are exact with a first-index tie-break (SURVEY.md §4
kernel-vs-reference)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from constraint_solver_tpu.models.nqueens import (
    block_scores,
    build_state,
    make_nqueens_problem,
)
from constraint_solver_tpu.ops.lex import lex_argmin
from constraint_solver_tpu.ops.nqueens_pallas import nqueens_block_kernel
from constraint_solver_tpu.utils.oracles import nqueens_conflicts

IMPLS = {
    "xla": jax.jit(block_scores),
    "kernel": functools.partial(nqueens_block_kernel, interpret=True),
}


def _block_inputs(n, a, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=n)
    st = build_state(jnp.asarray(rows, jnp.int32))
    c = jnp.asarray(rng.choice(n, size=a, replace=False), jnp.int32)
    r = st.rows[c]
    d = r - c + (n - 1)
    aa = r + c
    removed = (st.rc[r] - 1) + (st.dc[d] - 1) + (st.ac[aa] - 1)
    cur = jnp.float32(nqueens_conflicts(rows))
    return rows, (st.rc, st.dc, st.ac, c, r, removed, cur)


def _block_case(n, a, seed, impl="xla"):
    rows, args = _block_inputs(n, a, seed)
    out = IMPLS[impl](*args)
    return rows, np.asarray(args[3]), [np.asarray(x) for x in out]


def _rescore(rows, col, row):
    moved = rows.copy()
    moved[col] = row
    return nqueens_conflicts(moved)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("n,a", [(16, 3), (32, 5)])
def test_block_matches_full_rescore(n, a, impl):
    rows, c, (scores, row_min, row_arg) = _block_case(n, a, seed=0, impl=impl)
    assert scores.shape == (a, n)
    for j in range(a):
        for rp in range(n):
            assert scores[j, rp] == _rescore(rows, c[j], rp), (n, int(c[j]), rp)
    np.testing.assert_array_equal(row_min, scores.min(axis=1))
    np.testing.assert_array_equal(row_arg, scores.argmin(axis=1))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_block_row_min_at_large_board(impl):
    """A board of several kernel row blocks (n=14000): min/argmin stay exact
    with first-index tie-break; a few candidates are spot-checked against
    full rescores."""
    n, a = 14000, 3
    rows, c, (scores, row_min, row_arg) = _block_case(n, a, seed=7, impl=impl)
    np.testing.assert_array_equal(row_min, scores.min(axis=1))
    np.testing.assert_array_equal(row_arg, scores.argmin(axis=1))
    for j in range(a):
        for rp in (0, int(row_arg[j]), n // 2, n - 1):
            assert scores[j, rp] == _rescore(rows, c[j], rp)


def test_problem_neighborhood_hint_is_flat_argmin():
    """The problem's hint_idx (assembled from the block's row minima) is the
    exact flat lex_argmin of its scores, and each score is a full rescore."""
    n = 24
    p = make_nqueens_problem(n)
    rows = np.random.default_rng(1).integers(0, n, size=n)
    st = build_state(jnp.asarray(rows, jnp.int32))
    nb = p.neighborhood(st, p.score(st), jax.random.key(5))
    assert int(nb.hint_idx) == int(lex_argmin(nb.scores, nb.valid))
    scores = np.asarray(nb.scores)
    cols, new_rows = (np.asarray(m) for m in nb.moves)
    for i in np.flatnonzero(np.asarray(nb.valid))[::7]:
        assert scores[i, 0] == _rescore(rows, cols[i], new_rows[i])


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_block_form_chosen_by_platform(backend, monkeypatch):
    """make_nqueens_problem runs the kernel when JAX's backend is a GPU and
    the XLA block everywhere else; both give the same neighborhood."""
    import constraint_solver_tpu.models.nqueens as nq

    calls = []

    def kernel(*args):
        calls.append("kernel")
        return nqueens_block_kernel(*args, interpret=True)

    monkeypatch.setattr(nq, "nqueens_block_kernel", kernel)
    monkeypatch.setattr(nq.jax, "default_backend", lambda: backend)
    n = 40
    p = nq.make_nqueens_problem.__wrapped__(n, sample_cols=4)  # uncached
    st = build_state(jnp.asarray(
        np.random.default_rng(2).integers(0, n, size=n), jnp.int32))
    nb = p.neighborhood(st, p.score(st), jax.random.key(0))
    assert calls == (["kernel"] if backend == "gpu" else [])
    monkeypatch.undo()
    want = make_nqueens_problem(n, sample_cols=4).neighborhood(
        st, p.score(st), jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(nb.scores), np.asarray(want.scores))
    assert int(nb.hint_idx) == int(want.hint_idx)


def test_hint_matches_argmin_over_random_states():
    n = 20
    p = make_nqueens_problem(n)

    rng = np.random.default_rng(7)
    for trial in range(20):
        rows = jnp.asarray(rng.integers(0, n, size=n), jnp.int32)
        st = build_state(rows)
        nb = p.neighborhood(st, p.score(st), jax.random.key(trial))
        if not bool(nb.valid.any()):
            continue
        assert int(nb.hint_idx) == int(lex_argmin(nb.scores, nb.valid)), trial


def test_nqueens_oracle_matches_pairwise_count():
    """The numpy line-count oracle equals the reference's pairwise
    definition (examples/nqueens/src/lib.rs:74-87, each pair twice)."""
    rng = np.random.default_rng(3)
    for n in (1, 4, 9, 17):
        rows = rng.integers(0, n, size=n)
        pairs = sum(
            rows[i] == rows[j] or abs(int(rows[i]) - int(rows[j])) == j - i
            for i in range(n) for j in range(i + 1, n)
        )
        assert nqueens_conflicts(rows) == 2 * pairs


def test_block_first_index_tie_break_across_kernel_blocks():
    """Equal row minima in two different kernel row blocks (rows 5 and
    1500 of 2100, blocks of 1024): both paths return the earlier row."""
    n = 2100
    _, (rc, dc, ac, c, r, removed, cur) = _block_inputs(n, 2, seed=11)
    r = jnp.asarray([2000, 2000], jnp.int32)
    rc = jnp.ones(n).at[5].set(0.0).at[1500].set(0.0).at[2000].set(10.0)
    dc, ac = jnp.ones_like(dc), jnp.ones_like(ac)
    for name, impl in IMPLS.items():
        scores, row_min, row_arg = (
            np.asarray(x) for x in impl(rc, dc, ac, c, r, removed, cur))
        assert scores[0, 5] == scores[0, 1500] == scores.min(), name
        np.testing.assert_array_equal(row_arg, [5, 5], err_msg=name)
        np.testing.assert_array_equal(row_min, scores.min(axis=1), err_msg=name)


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla_at_real_widths():
    """The kernel as compiled for the card equals the XLA path bit for bit
    at the benchmark's widths (n=1000, A=50 and n=16384, A=64)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    for n, a in ((1000, 50), (16384, 64)):
        _, args = _block_inputs(n, a, seed=n)
        got = nqueens_block_kernel(*args)
        want = jax.jit(block_scores)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
