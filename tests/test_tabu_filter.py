"""Exact tabu filter (reference filter-then-pick, ref local_search.rs:319).

The engine resolves tabu two ways: pick-then-check with a bounded retry
budget (wide neighborhoods) and the reference-exact [W, T] filter (small
neighborhoods, auto-selected).  The retry budget exhausted on 59.8% of
iterations for the dense scheduling proposer (bench/tabu_exhaustion.py at
commit 9d1252d) — the exact filter removes that divergence entirely.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.history import TabuRing
from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.core.local_search import LsParams, ls_execute
from constraint_solver_tpu.models.nqueens import build_state, make_nqueens_problem
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.ops.lex import lex_argmin
from constraint_solver_tpu.parallel.population import PopulationSolver


def test_auto_threshold_selects_by_width():
    cfg = SolverConfig()  # ring capacity 512
    assert cfg.ls_params(250).tabu_exact_filter          # scheduling-like
    assert not cfg.ls_params(50_000).tabu_exact_filter   # nqueens-1000-like
    assert not cfg.ls_params(None).tabu_exact_filter     # unknown width
    assert SolverConfig(tabu_exact_filter=True).ls_params(50_000).tabu_exact_filter
    assert not SolverConfig(tabu_exact_filter=False).ls_params(8).tabu_exact_filter


def test_exact_filter_skips_tabu_candidates():
    """Seed the ring with the fingerprints of the top candidates; the exact
    filter must pick the best NON-tabu one (the reference invariant)."""
    n = 12
    problem = make_nqueens_problem(n)
    rows = jnp.asarray(np.random.default_rng(3).integers(0, n, n), jnp.int32)
    state = build_state(rows)
    score = problem.score(state)
    fp = problem.fingerprint(state)
    nb = problem.neighborhood(state, score, jax.random.key(0))

    # Fingerprints of every candidate; mark the 3 lexicographically best
    # as tabu by pushing them into a fresh ring.
    fps_all = jax.vmap(lambda i: problem.move_fp(state, fp, nb.moves, i))(
        jnp.arange(nb.valid.shape[0])
    )
    order = np.lexsort((
        np.arange(nb.valid.shape[0]),
        np.asarray(nb.scores[:, 1]),
        np.where(np.asarray(nb.valid), np.asarray(nb.scores[:, 0]), np.inf),
    ))
    tabu = TabuRing.create(64, 10_000)
    for idx in order[:3]:
        tabu = tabu.push(fps_all[idx])

    ok = np.asarray(nb.valid & ~tabu.is_tabu(fps_all))
    want = int(lex_argmin(nb.scores, jnp.asarray(ok)))
    assert want == order[3], "test setup: best non-tabu is the 4th candidate"

    params = LsParams(
        max_iterations=1, allow_no_improvement_for=10, tabu_exact_filter=True
    )
    best_state, best_score, _, iters, exhausted = ls_execute(
        problem, params, state, tabu, jax.random.key(0)
    )
    # One iteration: if the move improved, best == that move's state.
    cand_state = problem.apply_move(state, nb.moves, jnp.asarray(want))
    if bool(nb.scores[want, 0] < score[0]):
        np.testing.assert_array_equal(
            np.asarray(best_state.rows), np.asarray(cand_state.rows)
        )
    assert int(exhausted) == 0


def test_exact_filter_scheduling_no_exhaustion_and_quality():
    """The reference CLI scheduling instance under the auto-selected exact
    filter: retry exhaustion is structurally zero and quality holds."""
    spec = ScheduleSpec.from_dates(
        datetime.date(2022, 5, 9), datetime.date(2022, 6, 8), 7
    )
    problem = make_scheduling_problem(spec, proposer="dense")
    cfg = SolverConfig(
        seed="42",
        local_search_max_iterations=60,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=250,
        max_allow_no_improvement_for=10,
    )
    assert cfg.ls_params(problem.width).tabu_exact_filter
    solver = PopulationSolver(problem, cfg, population=4)
    solver.run(max_rounds=40, chunk=10)
    stats = solver.stats()
    assert stats["tabu_retry_exhausted"] == 0
    (hard, _soft), _ = solver.get_best_solution()
    assert hard == 0.0
