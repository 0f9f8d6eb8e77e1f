"""employee-scheduling-large (BASELINE config[5] shape): a year-long
schedule with 20 employees — the dense scorer and neighborhood must stay
correct and the solver must make progress."""

import datetime

import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.ils import Solver, SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.utils.oracles import scheduling_score as oracle_score


def _large_spec():
    start = datetime.date(2022, 1, 3)  # a Monday
    rng = np.random.default_rng(12)
    holidays = {
        emp: [
            start + datetime.timedelta(days=int(d))
            for d in rng.choice(365, size=10, replace=False)
        ]
        for emp in range(20)
    }
    return start, ScheduleSpec.from_dates(
        start, start + datetime.timedelta(days=364), 20, holidays
    ), holidays


def test_large_score_matches_oracle():
    start, spec, holidays = _large_spec()
    problem = make_scheduling_problem(spec, window_size=256)
    rng = np.random.default_rng(13)
    for _ in range(2):
        assign = rng.integers(0, 20, size=365)
        got = np.asarray(problem.score(jnp.asarray(assign, jnp.int32)))
        want = oracle_score(start, list(assign), holidays)
        assert (got[0], got[1]) == want


def test_large_solver_improves():
    _start, spec, _holidays = _large_spec()
    problem = make_scheduling_problem(spec, window_size=256)
    config = SolverConfig(
        seed="large",
        local_search_max_iterations=150,
        best_solutions_capacity=8,
        all_solutions_capacity=128,
        all_solution_iteration_expiry=150,
        iterated_local_search_max_iterations=8,
        max_allow_no_improvement_for=10,
    )
    solver = Solver(problem, config)
    import jax

    start_state = problem.init(jax.random.key(0))
    start_hard = float(np.asarray(problem.score(start_state))[0])
    solver.run(chunk=4)
    (hard, _), _ = solver.get_best_solution()
    assert hard < start_hard * 0.5, (
        f"large schedule: start {start_hard} -> {hard}, expected < 50%"
    )
