"""Probe: scheduling-365d-20e quality-at-wall on the GPU.

Logs (t, hard, soft) after every 2-round chunk for 60+ seconds so we can see
time-to-hard-zero and the soft convergence trajectory, not just a single
endpoint.  Run: python -u bench/sched_quality_probe.py [proposer] [pop]
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


def main() -> None:
    proposer = sys.argv[1] if len(sys.argv) > 1 else "dense"
    pop = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    budget = float(os.environ.get("PROBE_BUDGET", 65))
    ls_max = int(os.environ.get("PROBE_LS_MAX", 200))

    s_days, s_emps = 365, 20
    d0 = datetime.date(2024, 1, 1)
    spec = ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=s_days - 1), s_emps,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % s_days)
             for k in range(10)] for e in range(s_emps)},
    )
    n_rs = int(os.environ.get("PROBE_RAND_SWAPS", 64))
    problem = make_scheduling_problem(
        spec, proposer=proposer, n_rand_swaps=n_rs
    )
    print(f"n_rand_swaps={n_rs}", flush=True)
    tabu_mode = os.environ.get("PROBE_TABU", "auto")
    cfg = SolverConfig(
        seed="bench",
        local_search_max_iterations=ls_max,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=int(os.environ.get("PROBE_BAIL", 20)),
        tabu_exact_filter={"auto": None, "exact": True, "ptc": False}[tabu_mode],
    )
    print(f"tabu={tabu_mode} bail={cfg.max_allow_no_improvement_for}", flush=True)

    chunk = int(os.environ.get("PROBE_CHUNK", 2))
    print(f"proposer={proposer} pop={pop} ls_max={ls_max} chunk={chunk}",
          flush=True)
    t0 = time.time()
    warm = PopulationSolver(problem, cfg, population=pop, exchange_every=chunk)
    warm.run(max_rounds=chunk, chunk=chunk)
    print(f"warm-up {time.time() - t0:.1f}s", flush=True)

    solver = PopulationSolver(problem, cfg, population=pop, exchange_every=chunk)
    t0 = time.time()
    t_hard_zero = None
    rounds = 0
    while True:
        # One raw chunk dispatch + one 8-byte score probe per loop — the
        # run() wrapper's extra round-count probes cost a host sync each.
        solver.state = solver._chunk_jit(solver.state, chunk)
        rounds += chunk
        hard, soft = solver.get_best_score()
        el = time.time() - t0
        if t_hard_zero is None and hard == 0.0:
            t_hard_zero = el
        print(f"t={el:7.2f}s rounds={rounds:4d} "
              f"best=({hard:.0f}, {soft:.0f})", flush=True)
        if el >= budget or (hard, soft) == (0.0, 0.0):
            break
    solver._wall = time.time() - t0
    st = solver.stats()
    print(f"time-to-hard-zero: {t_hard_zero}", flush=True)
    print(f"stats: {st}", flush=True)


if __name__ == "__main__":
    main()
