"""Round-level overhead decomposition for scheduling-365d-20e at P=64.

The isolation table (bench/sched_isolation.py) itemizes the cost of one LS
ITERATION; it cannot see per-ROUND costs.  This harness measures them by
ablation:

- e2e            : the bench configuration (2-round chunks, probe per chunk)
- noprobe        : same dispatches, ONE final probe  -> probe RTT share
- noexchange     : k_exchange=0                      -> elite-exchange share
- norestart      : restart_every=10^9                -> restart-branch share
- noperturb      : identity perturbation             -> perturb+rescore share
- lsmax=N sweep  : straggler share (vmapped while_loop runs until the LAST
                   lane bails; productive fraction = counted iterations /
                   (P x estimated lockstep trips))

Every variant runs the same seed and round budget; walls are medians of
R4O_REPS repeats with forced host syncs.  ``R4O_ITER_MS`` is the
per-iteration time sched_isolation.py measured for the full engine on the
same device; the productive-fraction estimate needs it.  Run on the GPU:
    R4O_ITER_MS=<ms> python -u bench/sched_round_overhead.py
"""

import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.parallel.population import PopulationSolver

POP = int(os.environ.get("R4O_POP", 64))
ROUNDS = int(os.environ.get("R4O_ROUNDS", 40))
REPS = int(os.environ.get("R4O_REPS", 3))
ITER_MS = float(os.environ["R4O_ITER_MS"])  # sched_isolation.py, same device


def build_problem(perturb_identity=False):
    d0 = datetime.date(2024, 1, 1)
    spec = ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=364), 20,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % 365)
             for k in range(10)] for e in range(20)})
    p = make_scheduling_problem(spec, proposer="dense", n_rand_swaps=256)
    if perturb_identity:
        p = p._replace(perturb=lambda state, is_elite, key: state)
    return p


def build_cfg(ls=200, bail=20, restart=50):
    return SolverConfig(
        seed="ovh", local_search_max_iterations=ls,
        best_solutions_capacity=16, all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=bail, restart_every=restart)


def run_variant(name, problem, cfg, k_exchange=4, probe_each=True):
    walls, iters = [], 0
    for rep in range(REPS + 1):  # rep 0 = warm-up (compile), discarded
        s = PopulationSolver(problem, cfg, population=POP, exchange_every=2,
                             k_exchange=k_exchange)
        t0 = time.time()
        rounds = 0
        while rounds < ROUNDS:
            s.state = s._chunk_jit(s.state, 2)
            rounds += 2
            if probe_each:
                s.get_best_score()
        final = s.get_best_score()  # forced host sync ends the clock
        if rep > 0:
            walls.append(time.time() - t0)
            iters = s.stats()["ls_iterations"]
    walls.sort()
    wall = walls[len(walls) // 2]
    ms_round = wall * 1000 / ROUNDS
    rate = iters * problem.width / wall
    prod = iters * ITER_MS / 1000 / (POP * wall)  # productive fraction est.
    print(f"{name:28s} wall={wall:6.2f}s  {ms_round:7.1f} ms/round  "
          f"{rate:.3g} moves/s  iters={iters}  prod~{prod:.0%}  "
          f"best={final}", flush=True)
    return wall


def main():
    base_p = build_problem()
    print(f"P={POP} rounds={ROUNDS} reps={REPS} (medians; rep0 discarded)",
          flush=True)
    w_e2e = run_variant("e2e (bench config)", base_p, build_cfg())
    w_np = run_variant("noprobe", base_p, build_cfg(), probe_each=False)
    w_nx = run_variant("noexchange", base_p, build_cfg(), k_exchange=0)
    w_nr = run_variant("norestart", base_p, build_cfg(restart=10**9))
    w_npe = run_variant("noperturb", build_problem(True), build_cfg())
    for ls, bail in ((100, 20), (50, 20), (400, 20)):
        run_variant(f"lsmax={ls}", base_p, build_cfg(ls=ls, bail=bail))
    ms = lambda w: (w_e2e - w) * 1000 / ROUNDS
    print(f"\nper-round shares vs e2e: probe {ms(w_np):.1f} ms, "
          f"exchange {ms(w_nx):.1f} ms, restart-branch {ms(w_nr):.1f} ms, "
          f"perturb {ms(w_npe):.1f} ms", flush=True)


if __name__ == "__main__":
    main()
