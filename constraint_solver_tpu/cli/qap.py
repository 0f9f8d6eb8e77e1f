"""QAP CLI — the matmul-heavy domain (no reference counterpart).

Solves a random symmetric Taillard-style instance (models/qap.py) with the
same solver stack as the reference-mirroring CLIs; every LS iteration scores
the full n(n-1)/2 swap neighborhood with one [n, n] matmul.

Usage:
    python -m constraint_solver_tpu.cli.qap --size 64 --rounds 100
"""

from __future__ import annotations

import argparse
import time

from constraint_solver_tpu.utils import backend


def main(argv=None):
    parser = argparse.ArgumentParser(description="QAP example")
    parser.add_argument("--seed", "-s", default="42")
    parser.add_argument("--size", "-n", type=int, default=64)
    parser.add_argument("--instance-seed", type=int, default=0)
    parser.add_argument("--population", "-p", type=int, default=1)
    parser.add_argument("--rounds", type=int, default=100)
    backend.add_platform_arg(parser)
    parser.add_argument(
        "--compact", action=argparse.BooleanOptionalAction, default=None,
        help="row-min candidate compaction (models/qap.py compact=True), "
        "identical winners; default: on for 512 <= --size < 4096",
    )
    parser.add_argument(
        "--incremental", action=argparse.BooleanOptionalAction, default=None,
        help="carry G/H in state with exact rank-2 swap updates "
        "(models/qap.py incremental=True): no per-iteration matmuls; "
        "default: on for --size >= 4096",
    )
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)
    if args.incremental is None:
        args.incremental = args.size >= 4096
    if args.compact is None:
        args.compact = args.size >= 512 and not args.incremental

    backend.init(args.platform)

    import jax.numpy as jnp
    import numpy as np

    from constraint_solver_tpu.core.ils import Solver, SolverConfig
    from constraint_solver_tpu.models.qap import (
        QAPSpec,
        make_qap_problem,
        qap_cost_int32,
        qap_cost_naive,
    )
    from constraint_solver_tpu.parallel.population import PopulationSolver

    print("qap example")
    spec = QAPSpec.random(args.size, seed=args.instance_seed)
    problem = make_qap_problem(
        spec, compact=args.compact, incremental=args.incremental)
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=100,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=args.rounds,
        max_allow_no_improvement_for=5,
    )
    t0 = time.time()
    if args.population > 1:
        solver = PopulationSolver(problem, config, population=args.population)
    else:
        solver = Solver(problem, config)
    solver.run()
    (hard, _), best = solver.get_best_solution()
    wall = time.time() - t0

    # Cross-check against the float64 host oracle, exactly: the device's
    # int32 cost of the best permutation (carried by the incremental
    # QAPState, else recomputed) must equal it, and the recorded score must
    # be its float32 rounding (models/qap.py).
    flow, dist = spec.arrays()
    if hasattr(best, "p"):
        perm, device_cost = best.p, int(best.cost)
    else:
        perm = best
        device_cost = int(qap_cost_int32(flow, dist, jnp.asarray(perm)))
    oracle = qap_cost_naive(flow, dist, np.asarray(perm))
    if device_cost != oracle or hard != np.float32(oracle):
        raise RuntimeError(f"device cost {device_cost} (recorded {hard}) "
                           f"!= host cost {oracle}")
    if not args.quiet:
        print("result.permutation:", np.asarray(perm).tolist())
    print(f"result.cost: {device_cost}")
    print(f"stats: {solver.stats()} wall: {wall:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
