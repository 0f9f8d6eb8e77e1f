"""QAP at matmul scale: moves/s and roofline point against n and P.

At n=1024 the all-pairs swap neighborhood is one [1024,1024] x [1024,1024]
matmul per iteration per lane (~2.1 GFLOP); if small shapes are
latency-limited, the roofline share must rise steeply with n and P.
This script records moves/s + the XLA-accounted roofline point (against
the device's entry in utils/roofline.PEAKS) for (n, P) in QAP_ARMS
(default 256x64 anchor, 1024x16, 1024x64, 2048x16).

Run (GPU): python -u bench/qap_scale.py
Env: QAP_ARMS csv of nxP (e.g. "1024x64,2048x16"), QAP_ROUNDS (6).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu.parallel.population import PopulationSolver

ROUNDS = int(os.environ.get("QAP_ROUNDS", 6))


def arm(n, pop, chunk=2, compact=False, incremental=False):
    problem = make_qap_problem(
        QAPSpec.random(n, seed=0), compact=compact, incremental=incremental)
    config = SolverConfig(
        seed="bench",
        local_search_max_iterations=50,
        best_solutions_capacity=8,
        all_solutions_capacity=128,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=5,
    )
    label = f"qap-{n}{'c' if compact else ''}{'i' if incremental else ''} P={pop}"
    solver = PopulationSolver(problem, config, population=pop)
    t0 = time.time()
    solver.run(max_rounds=2, chunk=chunk)  # compile warm-up
    print(f"{label}: warm-up {time.time() - t0:.1f}s", flush=True)
    solver = PopulationSolver(problem, config, population=pop)
    t0 = time.time()
    solver.run(max_rounds=ROUNDS, chunk=chunk)
    wall = time.time() - t0
    (hard, soft), _ = solver.get_best_solution()
    stats = solver.stats()
    moves = stats["moves_evaluated"]
    print(
        f"{label}: rounds={ROUNDS} wall={wall:.2f}s best={hard} "
        f"ls_iters={stats['ls_iterations']} moves/s={moves / wall:.3g}",
        flush=True,
    )
    from constraint_solver_tpu.utils.roofline import format_roofline, peaks_for

    peaks = peaks_for(jax.devices()[0].device_kind)
    print(f"{label}: {format_roofline(solver.roofline(peaks, chunk=chunk))}",
          flush=True)


def main():
    print(f"devices: {jax.devices()}", flush=True)
    # Trailing "c" on an arm selects the row-min compact proposer
    # (models/qap.py compact=True), trailing "i" the incremental G/H
    # rank-2-update variant (incremental=True), e.g. "1024x16c,2048x16i".
    arms = os.environ.get("QAP_ARMS", "256x64,1024x16,1024x64,2048x16")
    for a in arms.split(","):
        compact, incremental = a.endswith("c"), a.endswith("i")
        n, pop = (int(v) for v in a.rstrip("ci").split("x"))
        arm(n, pop, compact=compact, incremental=incremental)


if __name__ == "__main__":
    main()
