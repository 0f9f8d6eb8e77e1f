"""Configuration presets mirroring the reference's hard-coded constants.

The reference exposes only ``--seed``/``--board-size`` on the nqueens CLI;
every other hyperparameter is a constant at each entry point (SURVEY.md §5
"Config / flag system").  These presets reproduce those constants so a
reference user finds the same defaults here.
"""

from __future__ import annotations

from constraint_solver_tpu.core.ils import SolverConfig


def nqueens_cli(seed: str = "42") -> SolverConfig:
    """reference examples/nqueens/src/main.rs:129-135 (window = 5n is the
    problem-side neighborhood, see make_nqueens_problem)."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=10_000,
        best_solutions_capacity=32,
        all_solutions_capacity=512,   # dense tabu ring (ref HashSet cap 100k)
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=5,
    )


def scheduling_cli(seed: str = "42") -> SolverConfig:
    """reference examples/employee-scheduling/src/main.rs:25-31 == the wasm
    bridge constants (web/employee-scheduling-wasm-bindgen/src/lib.rs:30-37);
    window_size=100 goes to make_scheduling_problem."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=1_000,
        best_solutions_capacity=64,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=250,
        max_allow_no_improvement_for=20,
    )


def scheduling_quality(seed: str = "42") -> SolverConfig:
    """The quality-at-wall production configuration: the reference CLI
    engine constants with bench-chosen archive/ring capacities, meant to
    drive a ``PopulationSolver`` over ``make_scheduling_problem(spec,
    proposer="random", window_size=100)`` with ``exchange_every=2``,
    ``cull_frac=0.25`` and population 64-128.  Chosen by quality-at-wall
    sweeps against the C++ reference baseline on earlier hardware; not yet
    measured on the H100."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=1_000,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
    )


def scheduling_dense_quality(seed: str = "42") -> SolverConfig:
    """The NOISY-DENSE quality configuration (bench/sched_quality_r5.py):
    the dense all-moves proposer (``make_scheduling_problem(spec,
    proposer="dense", n_rand_swaps=256)``) with the applied move
    Gumbel-sampled from the 64 best candidates at temperature 0.5 instead
    of the global argmin, over a P=64 population with elite exchange every
    2 rounds.  ``scheduling_quality`` (the random-window population) is
    the other quality mode; this is the dense alternative.  Chosen on
    earlier hardware; not yet measured on the H100."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=200,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
        select_topk=64,
        select_temp=0.5,
    )


def ackley_test(seed: str = "0") -> SolverConfig:
    """reference local-search/src/iterated_local_search.rs:222-256 (the ILS
    convergence tests; min/max move sizes 1e-3/0.5 go to
    make_ackley_problem)."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=100_000,
        best_solutions_capacity=16,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=5,
    )
