"""Dense-block scheduling neighborhood: exactness vs the full rescore.

The dense proposer scores ALL D x E ChangeDay moves plus n_off SwapDays
diagonals in one shot (models/scheduling.py neighborhood_dense).  Every
valid candidate's delta score must equal the full rescore of the applied
move, bit-exact — including the coupled swap corrections (S2/S4) and the
window-disjoint swap decomposition for H2/H3/H4/S1.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from constraint_solver_tpu.core.ils import Solver, SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)

D0 = datetime.date(2022, 5, 9)


def _spec(days, emps, holidays=None, start=D0):
    return ScheduleSpec.from_dates(
        start, start + datetime.timedelta(days=days - 1), emps, holidays
    )


SPECS = [
    _spec(31, 7),  # reference CLI instance (swaps active: delta in [14, 31))
    _spec(31, 7, {0: [D0 + datetime.timedelta(days=3)],
                  2: [D0 + datetime.timedelta(days=k) for k in (5, 6, 20)]}),
    _spec(15, 3),   # smallest swap-active size (delta = 14 only)
    _spec(14, 2),   # H4 active, swaps inactive (D < 15)
    _spec(9, 3),    # H3 active only
    _spec(7, 4),    # S1 active only
    _spec(3, 2),    # windows mostly inactive
    _spec(42, 5, {1: [D0 + datetime.timedelta(days=k) for k in range(0, 42, 7)]}),
    # Non-Monday start exercises the weekday/weekend layout (incl. the
    # swap-block's computed wd2/wkd2).
    _spec(30, 4, None, start=datetime.date(2022, 5, 13)),
]


@pytest.mark.parametrize(
    "spec", SPECS, ids=lambda s: f"{s.num_days}d{s.num_employees}e"
)
def test_dense_block_equals_full_rescore(spec):
    problem = make_scheduling_problem(spec, proposer="dense")
    for trial in range(3):
        key = jax.random.key(hash((spec.num_days, trial, 7)) % (2**31))
        k_init, k_nb = jax.random.split(key)
        assign = problem.init(k_init)
        cur = problem.score(assign)
        nb = jax.jit(problem.neighborhood)(assign, cur, k_nb)
        w_total = nb.valid.shape[0]
        assert w_total == problem.width
        idxs = jnp.arange(w_total)
        states = jax.vmap(lambda i: problem.apply_move(assign, nb.moves, i))(
            idxs
        )
        want = np.asarray(jax.vmap(problem.score)(states))
        got = np.asarray(nb.scores)
        valid = np.asarray(nb.valid)
        assert valid.any()
        np.testing.assert_array_equal(got[valid], want[valid])


def test_dense_block_covers_all_changedays():
    """The block enumerates every (day, employee) ChangeDay move exactly
    once, plus n_rand unrestricted random swaps, plus n_off window-disjoint
    swap diagonals."""
    spec = _spec(31, 7)
    problem = make_scheduling_problem(
        spec, proposer="dense", n_swap_offsets=4, n_rand_swaps=16
    )
    assert problem.width == 31 * 7 + 16 + 4 * 31
    assign = problem.init(jax.random.key(0))
    nb = problem.neighborhood(assign, problem.score(assign), jax.random.key(1))
    is_swap, d1, d2, new_emp = (np.asarray(m) for m in nb.moves)
    ch = ~is_swap
    got_pairs = set(zip(d1[ch].tolist(), new_emp[ch].tolist()))
    assert got_pairs == {(d, e) for d in range(31) for e in range(7)}
    # Block layout: [D*E ChangeDay] [n_rand random swaps] [n_off diagonals].
    rs = slice(31 * 7, 31 * 7 + 16)
    assert is_swap[rs].all() and (d1[rs] != d2[rs]).all()
    # Diagonal swap partners are >= 14 days later (window-disjoint
    # decomposition); the random block has no such restriction.
    diag_valid = is_swap & np.asarray(nb.valid)
    diag_valid[rs] = False
    assert ((d2 - d1)[diag_valid] >= 14).all()


def test_dense_noisy_selection_end_to_end():
    """select_topk > 1 samples the applied move from the top-k of the dense
    block.  The solver must still reach the
    reference-quality region, its recorded best must pass the independent
    full-rescore integrity check, and the trajectory must actually differ
    from the argmin engine's (the noise is live)."""
    spec = _spec(31, 7)
    problem = make_scheduling_problem(spec, proposer="dense")

    def cfg(**kw):
        return SolverConfig(
            seed="dense",
            local_search_max_iterations=200,
            iterated_local_search_max_iterations=40,
            all_solutions_capacity=128,
            all_solution_iteration_expiry=400,
            best_solutions_capacity=16,
            max_allow_no_improvement_for=10,
            **kw,
        )

    noisy = Solver(problem, cfg(select_topk=64, select_temp=1.0))
    noisy.run(max_rounds=40, chunk=10)
    (hard, soft), assign = noisy.get_best_solution()
    assert hard == 0.0, (hard, soft)
    assert soft <= 12.0, (hard, soft)
    # Independent integrity: the recorded best == full rescore of the state.
    rescored = np.asarray(problem.score(jnp.asarray(assign)))
    assert (hard, soft) == (float(rescored[0]), float(rescored[1]))

    argmin = Solver(problem, cfg())
    argmin.run(max_rounds=40, chunk=10)
    assert np.asarray(argmin.state.current_fp).tolist() != \
        np.asarray(noisy.state.current_fp).tolist()


@pytest.mark.parametrize("proposer", ["dense", "random", "rescore"])
def test_fp_deltas_match_applied_fingerprints(proposer):
    """Neighborhood.fp_deltas contract: cur_fp ^ fp_deltas[i] must equal the
    fingerprint of the applied candidate, for every valid candidate of every
    block (the engine's exact tabu filter keys on this)."""
    spec = _spec(31, 7, {0: [D0 + datetime.timedelta(days=3)]})
    problem = make_scheduling_problem(
        spec, proposer=proposer, n_rand_swaps=16
    )
    assign = problem.init(jax.random.key(5))
    cur_fp = problem.fingerprint(assign)
    nb = problem.neighborhood(assign, problem.score(assign), jax.random.key(6))
    assert nb.fp_deltas is not None
    idxs = jnp.arange(nb.valid.shape[0])
    states = jax.vmap(lambda i: problem.apply_move(assign, nb.moves, i))(idxs)
    want = np.asarray(jax.vmap(problem.fingerprint)(states))
    got = np.asarray(cur_fp[None, :] ^ nb.fp_deltas)
    valid = np.asarray(nb.valid)
    np.testing.assert_array_equal(got[valid], want[valid])


def test_dense_solver_end_to_end():
    """Engine + dense proposer reach the reference-quality region on the
    31d x 7e instance."""
    spec = _spec(31, 7)
    problem = make_scheduling_problem(spec, proposer="dense")
    cfg = SolverConfig(
        seed="dense",
        local_search_max_iterations=200,
        iterated_local_search_max_iterations=40,
        all_solutions_capacity=128,
        all_solution_iteration_expiry=400,
        best_solutions_capacity=16,
        max_allow_no_improvement_for=10,
    )
    s = Solver(problem, cfg)
    s.run(max_rounds=40, chunk=10)
    (hard, soft), assign = s.get_best_solution()
    assert hard == 0.0, (hard, soft)
    assert soft <= 12.0, (hard, soft)
    assert len(assign) == 31
