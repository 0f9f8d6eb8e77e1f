"""Quality A/Bs on scheduling-365d-20e: cull rank, exchange cadence, noisy
dense selection.

Arms (SWEEP_SET csv; default all), each raced at 2.3/10/60 s with 3
fresh-state repeats using the on-device per-round best trace (bench.py
device_best_at_walls — no probe lag, honest exchange cadence):

- lex          production quality mode, lexicographic cull rank (new default)
- hard         same mode with the round-4 hard-channel cull rank
- exch1        lex + exchange/cull every ROUND
- dense_argmin the dense shallow rs=256 quality config (anchor)
- dense_t05/t1/t2  dense + noisy top-64 selection at temp 0.5 / 1.0 / 2.0
               (ops/lex.noisy_lex_select): full-width evaluation with a
               noisy descent's diffusion

Dense arms run P=64; random-window arms run P=128.

Run (GPU): python -u bench/sched_quality_r5.py
Env: SWEEP_SET, SWEEP_REPS (3), SWEEP_BUDGETS, RUN_BASELINE=1 to also
re-measure the C++ side in this process.
"""

import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (device_best_at_walls / lex_median_worst reuse)
from constraint_solver_tpu.core.ils import SolverConfig  # noqa: E402
from constraint_solver_tpu.models.scheduling import (  # noqa: E402
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.parallel.population import PopulationSolver  # noqa: E402

BUDGETS = [float(b) for b in
           os.environ.get("SWEEP_BUDGETS", "2.3,10,60").split(",")]
REPS = int(os.environ.get("SWEEP_REPS", 3))

ARMS = ["lex", "hard", "exch1", "dense_argmin", "dense_t05", "dense_t1",
        "dense_t2"]
# Follow-up arms (run via SWEEP_SET): dense_t025 probes below the measured
# t=0.5 sweet spot; dense_t05_cull adds the rank-based culling that closed
# the random-window mode's early race in round 4.


def make_spec():
    d0 = datetime.date(2024, 1, 1)
    return ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=364), 20,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % 365)
             for k in range(10)] for e in range(20)},
    )


def make_solver(arm, spec, seed):
    if arm.startswith("dense"):
        temp = {"dense_t025": 0.25, "dense_t05": 0.5, "dense_t1": 1.0,
                "dense_t2": 2.0, "dense_t05_cull": 0.5}.get(arm, 1.0)
        topk = 0 if arm == "dense_argmin" else 64
        cull = 0.25 if arm.endswith("_cull") else 0.0
        problem = make_scheduling_problem(spec, proposer="dense",
                                          n_rand_swaps=256)
        cfg = SolverConfig(
            seed=seed,
            local_search_max_iterations=200,
            best_solutions_capacity=16,
            all_solutions_capacity=256,
            all_solution_iteration_expiry=1_000,
            iterated_local_search_max_iterations=100_000,
            max_allow_no_improvement_for=20,
            select_topk=topk,
            select_temp=temp,
        )
        return PopulationSolver(problem, cfg, population=64,
                                exchange_every=2, cull_frac=cull), 2
    problem = make_scheduling_problem(spec, proposer="random",
                                      window_size=100)
    cfg = SolverConfig(
        seed=seed,
        local_search_max_iterations=1_000,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
    )
    exch = 1 if arm == "exch1" else 2
    rank = "hard" if arm == "hard" else "lex"
    return PopulationSolver(problem, cfg, population=128, exchange_every=exch,
                            cull_frac=0.25, cull_rank=rank), 2


def main():
    arms = os.environ.get("SWEEP_SET")
    arms = arms.split(",") if arms else ARMS
    spec = make_spec()

    if os.environ.get("RUN_BASELINE"):
        bq = bench.baseline_quality(["scheduling", "365", "20"], BUDGETS)
        print(f"baseline median/worst: {bq}", flush=True)

    for arm in arms:
        t0 = time.time()
        warm, chunk = make_solver(arm, spec, "warm")
        warm.execute_chunk_traced(chunk)
        print(f"{arm}: warm-up {time.time() - t0:.1f}s", flush=True)
        runs = []
        for rep in range(REPS):
            s, chunk = make_solver(arm, spec, f"bench{rep}")
            r = bench.device_best_at_walls(lambda: s, BUDGETS, chunk)
            runs.append(r)
            print(f"  {arm} rep={rep}: {r}", flush=True)
        med, worst = bench.lex_median_worst(runs)
        print(f"{arm}: median={med} worst={worst}", flush=True)


if __name__ == "__main__":
    main()
