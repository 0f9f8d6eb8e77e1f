"""Employee-scheduling scorer tests.

An independent, date-based Python oracle transcribes the reference's
8-constraint semantics (examples/employee-scheduling/src/lib.rs:265-374,
weekday-consistency :194-218), and the dense jnp scorer is property-tested
against it over random assignments, calendars, and holiday sets.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.utils.oracles import scheduling_score as oracle_score


def _random_case(rng, num_days, num_emp, with_holidays):
    start = datetime.date(2022, 5, 1) + datetime.timedelta(days=int(rng.integers(0, 14)))
    holidays = {}
    if with_holidays:
        for emp in range(num_emp):
            n_h = int(rng.integers(0, 3))
            holidays[emp] = [
                start + datetime.timedelta(days=int(rng.integers(0, num_days)))
                for _ in range(n_h)
            ]
    spec = ScheduleSpec.from_dates(
        start, start + datetime.timedelta(days=num_days - 1), num_emp, holidays
    )
    assign = rng.integers(0, num_emp, size=num_days)
    return start, spec, assign, holidays


def test_score_matches_oracle():
    rng = np.random.default_rng(9)
    for num_days, num_emp in [(31, 7), (14, 3), (9, 2), (60, 5), (7, 4)]:
        for with_holidays in (False, True):
            for _ in range(3):
                start, spec, assign, holidays = _random_case(
                    rng, num_days, num_emp, with_holidays
                )
                problem = make_scheduling_problem(spec)
                got = np.asarray(problem.score(jnp.asarray(assign, jnp.int32)))
                want = oracle_score(start, list(assign), holidays)
                assert got[0] == want[0], f"hard mismatch: {got[0]} != {want[0]}"
                assert got[1] == want[1], f"soft mismatch: {got[1]} != {want[1]}"


def test_reference_cli_instance_shape():
    """The reference CLI instance: 7 employees, 2022-05-09 + 30 days
    (examples/employee-scheduling/src/main.rs:11-21)."""
    start = datetime.date(2022, 5, 9)
    spec = ScheduleSpec.from_dates(start, start + datetime.timedelta(days=30), 7)
    assert spec.num_days == 31
    assert spec.start_weekday == 0  # Monday
    problem = make_scheduling_problem(spec)
    assign = jnp.zeros((31,), jnp.int32)  # employee 0 every day
    hard, soft = np.asarray(problem.score(assign))
    want = oracle_score(start, [0] * 31, {})
    assert (hard, soft) == want
    assert hard > 0  # 30 consecutive-day violations at minimum


def test_neighborhood_scores_match_oracle():
    rng = np.random.default_rng(10)
    start = datetime.date(2022, 5, 9)
    spec = ScheduleSpec.from_dates(start, start + datetime.timedelta(days=30), 7)
    problem = make_scheduling_problem(spec, window_size=16)
    assign = jnp.asarray(rng.integers(0, 7, size=31), jnp.int32)
    nb = problem.neighborhood(assign, problem.score(assign), jax.random.key(2))
    for i in range(16):
        # Moves are compact (is_swap, d1, d2, new_emp) tuples; materialize
        # candidate i via apply_move, then oracle-check its delta score.
        cand_state = problem.apply_move(assign, nb.moves, jnp.int32(i))
        cand = list(np.asarray(cand_state))
        want = oracle_score(start, cand, {})
        got = np.asarray(nb.scores[i])
        assert (got[0], got[1]) == want
        # Moves must be ChangeDay (1 day differs) or SwapDays (2 days swap).
        diff = np.flatnonzero(np.asarray(cand_state) != np.asarray(assign))
        assert len(diff) <= 2
