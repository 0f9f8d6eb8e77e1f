"""N-Queens CLI, mirroring the reference binary.

Reference: examples/nqueens/src/main.rs — clap args ``--seed`` (default "42")
and ``--board-size`` (default 8) at main.rs:97-125; fixed hyperparameters at
main.rs:129-135.  Extras: ``--population`` runs a vmapped trajectory
portfolio, ``--platform cpu`` forces the host backend.

Usage:
    python -m constraint_solver_tpu.cli.nqueens --seed 42 --board-size 8
"""

from __future__ import annotations

import argparse
import time

from constraint_solver_tpu.utils import backend


def main(argv=None):
    parser = argparse.ArgumentParser(description="Local search N-Queens example")
    parser.add_argument("--seed", "-s", default="42", help="random seed, any string")
    parser.add_argument("--board-size", "-b", type=int, default=8)
    parser.add_argument("--population", "-p", type=int, default=1,
                        help="parallel ILS trajectories")
    parser.add_argument("--algo", choices=["ils", "pmc"], default="ils",
                        help="ils = reference-style iterated local search; "
                        "pmc = synchronous parallel min-conflicts")
    parser.add_argument("--rounds", type=int, default=10_000,
                        help="max ILS rounds (ref: 10_000)")
    parser.add_argument("--pmc-sample-cols", type=int, default=None,
                        help="PMC huge-board mode: score [A, n] sampled "
                        "columns per step instead of the full [n, n] block")
    backend.add_platform_arg(parser)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="snapshot solver state here every "
                        "--checkpoint-every rounds; if PATH exists, resume "
                        "from it (ils algos; not pmc)")
    parser.add_argument("--checkpoint-every", type=int, default=200)
    args = parser.parse_args(argv)

    backend.init(args.platform)

    from constraint_solver_tpu.core.ils import Solver, SolverConfig
    from constraint_solver_tpu.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu.parallel.population import PopulationSolver
    from constraint_solver_tpu.utils.printing import format_board

    print("local search n-queens example")
    n = args.board_size
    # Reference hyperparameters (main.rs:129-135); window = 5n becomes the
    # sampled-columns x all-rows dense neighborhood.
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=10_000,
        best_solutions_capacity=32,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=args.rounds,
        max_allow_no_improvement_for=5,
    )
    problem = make_nqueens_problem(n)
    t0 = time.time()
    if args.algo == "pmc":
        from constraint_solver_tpu.models.nqueens_parallel import (
            ParallelMinConflictsSolver,
        )

        if args.checkpoint:
            print("warning: --checkpoint is ignored with --algo pmc "
                  "(pmc runs are single-dispatch chunks, not resumable)")
        solver = ParallelMinConflictsSolver(
            n,
            seed=args.seed,
            population=args.population,
            sample_cols=args.pmc_sample_cols,
        )
    else:
        from constraint_solver_tpu.utils.checkpoint import resume_and_run

        if args.population > 1:
            solver = PopulationSolver(
                problem, config, population=args.population
            )
        else:
            solver = Solver(problem, config)
        resume_and_run(solver, args.checkpoint, args.checkpoint_every)
    (hard, _soft), best_state = solver.get_best_solution()
    wall = time.time() - t0

    if not args.quiet:
        print("result.solution:")
        print(format_board(best_state.rows))
    print(f"result.score: {int(hard)}")
    stats = solver.stats()
    print(f"stats: {stats} wall: {wall:.2f}s")
    return int(hard)


if __name__ == "__main__":
    raise SystemExit(0 if main() == 0 else 1)
