"""Scheduling-365d-20e quality-at-wall config sweep, one process.

Races the C++ full-reference baseline (bench/baseline_full.cc, single
thread) on soft score at 60 s.  This sweep probes the levers — population size,
elite-exchange cadence (diversity), descent depth (ls_max/bail), and the
unrestricted-random-swap width — each config solved for SWEEP_BUDGET
seconds from a fresh state in the same process (compiles amortized).

Run: python -u bench/sched_quality_sweep.py
Env: SWEEP_BUDGET (default 62 s), SWEEP_SET (csv of config names).
"""

import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.parallel.population import PopulationSolver

BUDGET = float(os.environ.get("SWEEP_BUDGET", 62))

# name -> (pop, exchange_every, ls_max, bail, n_rand_swaps)
CONFIGS = {
    "base64": (64, 2, 200, 20, 64),
    "p256": (256, 2, 200, 20, 64),
    "exch16": (64, 16, 200, 20, 64),
    "deep": (64, 2, 1000, 50, 64),
    "p256x16": (256, 16, 200, 20, 64),
    "swaps256": (64, 2, 200, 20, 256),
    # Combine the two levers: deeper descents reach the plateau sooner,
    # wide random swaps escape it.
    "deep_swaps256": (64, 2, 1000, 50, 256),
    "mid_swaps256": (64, 2, 400, 30, 256),
    "swaps512": (64, 2, 200, 20, 512),
}


def main() -> None:
    names = os.environ.get("SWEEP_SET")
    names = names.split(",") if names else list(CONFIGS)

    d0 = datetime.date(2024, 1, 1)
    spec = ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=364), 20,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % 365)
             for k in range(10)] for e in range(20)},
    )

    for name in names:
        pop, exch, ls_max, bail, n_rs = CONFIGS[name]
        problem = make_scheduling_problem(
            spec, proposer="dense", n_rand_swaps=n_rs,
        )
        cfg = SolverConfig(
            seed="bench",
            local_search_max_iterations=ls_max,
            best_solutions_capacity=16,
            all_solutions_capacity=256,
            all_solution_iteration_expiry=1_000,
            iterated_local_search_max_iterations=100_000,
            max_allow_no_improvement_for=bail,
        )
        chunk = min(exch, 2) if ls_max <= 200 else 1
        warm = PopulationSolver(problem, cfg, population=pop,
                                exchange_every=exch)
        t0 = time.time()
        warm.state = warm._chunk_jit(warm.state, chunk)
        print(f"{name}: warm-up {time.time() - t0:.1f}s", flush=True)

        s = PopulationSolver(problem, cfg, population=pop, exchange_every=exch)
        t0 = time.time()
        rounds = 0
        traj = []
        while True:
            s.state = s._chunk_jit(s.state, chunk)
            rounds += chunk
            best = s.get_best_score()
            el = time.time() - t0
            if not traj or traj[-1][1] != best:
                traj.append((round(el, 1), best))
            if el >= BUDGET or best == (0.0, 0.0):
                break
        s._wall = el
        st = s.stats()
        print(f"{name}: pop={pop} exch={exch} ls={ls_max} bail={bail} "
              f"rs={n_rs} -> best@{el:.0f}s {best} rounds={rounds} "
              f"{st['moves_per_sec']:.3g} moves/s", flush=True)
        print(f"  traj: {traj}", flush=True)


if __name__ == "__main__":
    main()
