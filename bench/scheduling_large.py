"""Employee-scheduling benchmark: large instance + delta-vs-rescore A/B.

Measures on one device:

1. Large instance (365 days x 20 employees, 10 holidays each): moves/s and
   time-to-(hard=0) with the delta-evaluation path, population P lanes.
2. The same instance with proposer="rescore" (identical trajectories,
   full-rescore scoring) — the delta-vs-rescore A/B.
3. The reference CLI instance (31d x 7e, wasm-bridge params) quality at the
   reference's 250-round budget.

Env knobs: SCHED_DAYS, SCHED_EMPS, SCHED_POP, SCHED_LS_MAX, SCHED_ROUNDS.
"""

import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.parallel.population import PopulationSolver

DAYS = int(os.environ.get("SCHED_DAYS", 365))
EMPS = int(os.environ.get("SCHED_EMPS", 20))
POP = int(os.environ.get("SCHED_POP", 64))
LS_MAX = int(os.environ.get("SCHED_LS_MAX", 200))
ROUNDS = int(os.environ.get("SCHED_ROUNDS", 60))


def large_spec() -> ScheduleSpec:
    start = datetime.date(2024, 1, 1)
    holidays = {
        e: [start + datetime.timedelta(days=(17 * e + 11 * k) % DAYS) for k in range(10)]
        for e in range(EMPS)
    }
    return ScheduleSpec.from_dates(
        start, start + datetime.timedelta(days=DAYS - 1), EMPS, holidays
    )


def solve(problem, config, pop, rounds, label, chunk=2):
    solver = PopulationSolver(problem, config, population=pop)
    t0 = time.time()
    solver.run(max_rounds=2, chunk=2)  # compile warm-up
    print(f"{label}: warm-up {time.time() - t0:.1f}s", flush=True)
    solver = PopulationSolver(problem, config, population=pop)
    t0 = time.time()
    solver.run(max_rounds=rounds, chunk=chunk)
    wall = time.time() - t0
    (hard, soft), _ = solver.get_best_solution()
    stats = solver.stats()
    moves = stats["moves_evaluated"]
    print(
        f"{label}: P={pop} rounds={stats['rounds']} wall={wall:.2f}s "
        f"best=({hard}, {soft}) ls_iters={stats['ls_iterations']} "
        f"moves/s={moves / wall:.3g}",
        flush=True,
    )
    return wall, moves, (hard, soft)


def main():
    print(f"devices: {jax.devices()}", flush=True)

    spec = large_spec()
    config = SolverConfig(
        seed="bench",
        local_search_max_iterations=LS_MAX,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
    )

    dense_p = make_scheduling_problem(spec, proposer="dense")
    w_n, m_n, s_n = solve(
        dense_p, config, POP, ROUNDS, f"sched-{DAYS}d-{EMPS}e-dense"
    )

    # Roofline: XLA-accounted flops/bytes of the dense chunk program.
    try:
        from constraint_solver_tpu.utils.roofline import (
            cost_analysis,
            format_roofline,
            peaks_for,
            roofline,
        )

        import jax as _jax

        peaks = peaks_for(_jax.devices()[0].device_kind)

        solver = PopulationSolver(dense_p, config, population=POP)
        jitted = _jax.jit(lambda st: solver._chunk_jit(st, 2))
        ca = cost_analysis(jitted, solver.state)
        t0 = time.time()
        st = jitted(solver.state)
        _jax.block_until_ready(st)
        t0 = time.time()
        st = jitted(st)
        _jax.block_until_ready(st)
        wall = time.time() - t0
        print(
            f"dense chunk roofline: {format_roofline(roofline(ca['flops'], ca['bytes'], 1, wall, peaks))}",
            flush=True,
        )
    except Exception as e:  # noqa: BLE001
        print(f"roofline skipped: {e}", flush=True)

    delta_p = make_scheduling_problem(spec, window_size=100, proposer="random")
    d_rounds = max(4, ROUNDS // 10)
    w_d, m_d, s_d = solve(
        delta_p, config, POP, d_rounds, f"sched-{DAYS}d-{EMPS}e-delta"
    )

    resc_p = make_scheduling_problem(spec, window_size=100, proposer="rescore")
    w_r, m_r, s_r = solve(
        resc_p, config, POP, d_rounds, f"sched-{DAYS}d-{EMPS}e-rescore"
    )

    per_move_n = w_n / max(m_n, 1)
    per_move_d = w_d / max(m_d, 1)
    per_move_r = w_r / max(m_r, 1)
    print(
        f"A/B dense vs sliced-delta vs rescore ({DAYS}d x {EMPS}e): "
        f"{1e9 * per_move_n:.1f} / {1e9 * per_move_d:.1f} / "
        f"{1e9 * per_move_r:.1f} ns/move "
        f"(dense = {per_move_r / per_move_n:.0f}x rescore)",
        flush=True,
    )

    # Reference CLI instance at the reference budget (quality gate).
    ref_spec = ScheduleSpec.from_dates(
        datetime.date(2022, 5, 9), datetime.date(2022, 6, 8), 7
    )
    ref_p = make_scheduling_problem(ref_spec, window_size=100)
    ref_cfg = SolverConfig(
        seed="bench",
        local_search_max_iterations=1_000,
        best_solutions_capacity=64,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=250,
        max_allow_no_improvement_for=20,
    )
    solve(ref_p, ref_cfg, POP, 250, "sched-ref-31d-7e")


if __name__ == "__main__":
    main()
