"""Smoke test of the solver's main path on one NVIDIA GPU.

Drives each workload once through the entry points a user calls
(``PopulationSolver``, ``Solver``, the QAP CLI and the HTTP service) at the
sizes the repository's benchmark uses, and checks every returned best score
against a plain full rescore on the host (``constraint_solver_tpu.utils
.oracles``, numpy float64 for QAP).  These domains are integer-valued, so
every comparison is exact.  It also runs the tests marked ``gpu``.

    python chip_smoke.py          # one GPU, every phase
    python chip_smoke.py --four   # four GPUs: the sharded phases only

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from constraint_solver_tpu.utils import compile_cache  # noqa: E402

# The benchmark's nqueens configuration (bench.py).
NQ_CONFIG = dict(
    local_search_max_iterations=250,
    all_solutions_capacity=256,
    best_solutions_capacity=8,
    iterated_local_search_max_iterations=10_000,
    max_allow_no_improvement_for=5,
)
SCHED_START = datetime.date(2024, 1, 1)
GPU_TEST_MODULES = ("test_pallas_kernels", "test_qap")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def sched_holidays(days: int, emps: int) -> dict:
    """The benchmark's instance family: employee e's 10 holidays fall on
    days (17e + 11k) % D (bench.py, bench/baseline_full.cc)."""
    return {
        e: [SCHED_START + datetime.timedelta(days=(17 * e + 11 * k) % days)
            for k in range(10)]
        for e in range(emps)
    }


def sched_spec(days: int, emps: int):
    from constraint_solver_tpu.models.scheduling import ScheduleSpec

    return ScheduleSpec.from_dates(
        SCHED_START, SCHED_START + datetime.timedelta(days=days - 1), emps,
        sched_holidays(days, emps),
    )


def check_equal(what: str, device, host) -> None:
    if device != host:
        raise AssertionError(f"{what}: device best {device} != host rescore {host}")


def check_nqueens(solver, want_zero: bool = False) -> float:
    from constraint_solver_tpu.utils.oracles import nqueens_conflicts

    (hard, _), state = solver.get_best_solution()
    check_equal("nqueens", hard, float(nqueens_conflicts(state.rows)))
    if want_zero and hard != 0:
        raise AssertionError(f"nqueens did not reach 0 conflicts: {hard}")
    return hard


def check_scheduling(solver, days: int, emps: int) -> tuple:
    from constraint_solver_tpu.utils.oracles import scheduling_score

    score, assign = solver.get_best_solution()
    want = scheduling_score(SCHED_START, [int(e) for e in assign],
                            sched_holidays(days, emps))
    check_equal("scheduling", tuple(score), want)
    return score


def nq_config(seed: str):
    from constraint_solver_tpu.core.ils import SolverConfig

    return SolverConfig(seed=seed, **NQ_CONFIG)


def dense_sched_solver(population: int, mesh=None, days: int = 365, emps: int = 20):
    from constraint_solver_tpu.core.ils import SolverConfig
    from constraint_solver_tpu.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu.parallel.population import PopulationSolver

    problem = make_scheduling_problem(sched_spec(days, emps), proposer="dense",
                                      n_rand_swaps=256)
    config = SolverConfig(
        seed="bench", local_search_max_iterations=50,
        best_solutions_capacity=16, all_solutions_capacity=64,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=20,
    )
    return PopulationSolver(problem, config, population=population,
                            exchange_every=4, mesh=mesh)


# -- one-card phases ------------------------------------------------------

def phase_nqueens1000():
    """The headline: nqueens-1000, P=256 ILS trajectories, run to 0."""
    from constraint_solver_tpu.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu.parallel.population import PopulationSolver

    problem = make_nqueens_problem(1000)
    t0 = time.perf_counter()
    PopulationSolver(problem, nq_config("warm"), population=256,
                     exchange_every=2).run(max_rounds=2, chunk=2)
    compile_s = time.perf_counter() - t0
    solver = PopulationSolver(problem, nq_config("bench"), population=256,
                              exchange_every=2)
    t0 = time.perf_counter()
    solver.run(chunk=2)
    wall = time.perf_counter() - t0
    check_nqueens(solver, want_zero=True)
    return (f"hard=0 rounds={solver.stats()['rounds']} warm-up {compile_s:.1f}s "
            f"solve {wall:.2f}s "
            f"{solver.stats()['ls_iterations'] * problem.width / wall:.4g} moves/s")


def phase_nqueens16384():
    """nqueens-16384, P=16, A=64 sampled columns, a few chunks."""
    from constraint_solver_tpu.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu.parallel.population import PopulationSolver

    problem = make_nqueens_problem(16384, sample_cols=64)
    solver = PopulationSolver(problem, nq_config("bench-big"), population=16,
                              exchange_every=2)
    t0 = time.perf_counter()
    solver.run(max_rounds=6, chunk=2)
    wall = time.perf_counter() - t0
    hard = check_nqueens(solver)
    return f"best={hard:g} after {solver.stats()['rounds']} rounds ({wall:.1f}s incl. compile)"


def phase_scheduling_dense():
    """Scheduling 365x20, the dense proposer at P=64, a few chunks."""
    solver = dense_sched_solver(64)
    t0 = time.perf_counter()
    solver.run(max_rounds=8, chunk=4)
    wall = time.perf_counter() - t0
    score = check_scheduling(solver, 365, 20)
    return f"best={score} ({wall:.1f}s incl. compile)"


def phase_scheduling_random():
    """Scheduling 365x20, the random-window quality mode at P=128."""
    from constraint_solver_tpu.core.ils import SolverConfig
    from constraint_solver_tpu.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu.parallel.population import PopulationSolver

    problem = make_scheduling_problem(sched_spec(365, 20), proposer="random",
                                      window_size=100)
    config = SolverConfig(
        seed="bench0", local_search_max_iterations=1_000,
        best_solutions_capacity=16, all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
    )
    solver = PopulationSolver(problem, config, population=128,
                              exchange_every=2, cull_frac=0.25)
    t0 = time.perf_counter()
    solver.run(max_rounds=6, chunk=2)
    wall = time.perf_counter() - t0
    score = check_scheduling(solver, 365, 20)
    return f"best={score} ({wall:.1f}s incl. compile)"


def _qap_cli(size: int) -> str:
    """The QAP CLI with its auto-selected proposer form; the CLI itself
    raises unless the device's int32 cost of its best permutation equals
    the float64 host cost exactly (and the recorded float32 score is that
    cost's rounding)."""
    import contextlib
    import io

    from constraint_solver_tpu.cli import qap as qap_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qap_cli.main(["--size", str(size), "--rounds", "3", "--quiet"])
    return " ".join(line for line in buf.getvalue().splitlines()
                    if line.startswith(("result.cost", "stats")))


def phase_qap1024():
    return _qap_cli(1024)


def phase_qap4096():
    return _qap_cli(4096)


def phase_server():
    """The HTTP service in this process: the reference UI's 7x31 instance
    and a 365x20 instance with a P=64 random-proposer population."""
    from constraint_solver_tpu.serve.server import run_server
    from constraint_solver_tpu.utils.oracles import scheduling_score

    server = run_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/solvers"

    def call(path, body=None):
        req = urllib.request.Request(
            url + path, method="POST",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def solve(payload, holidays, max_rounds):
        sid = call("", payload)["solverId"]
        for _ in range(max_rounds):
            res = call(f"/{sid}/round")
            if res["result"]["score"]["hard_score"] == 0 or res["isFinished"]:
                break
        start = datetime.date.fromisoformat(payload["startDate"])
        assign = [emp["id"] for _, emp in res["result"]["days_to_employees"]]
        score = res["result"]["score"]
        got = (score["hard_score"], score["soft_score"])
        check_equal("served scheduling", got, scheduling_score(start, assign, holidays))
        return f"rounds={res['iterationInfo']['current']} best={got}"

    try:
        small = solve({
            "startDate": "2022-05-09", "endDate": "2022-06-08",
            "employees": [{"id": i} for i in range(7)],
            "employeeHolidays": [[] for _ in range(7)],
        }, {}, max_rounds=20)
        hols = sched_holidays(365, 20)
        large = solve({
            "startDate": SCHED_START.isoformat(),
            "endDate": (SCHED_START + datetime.timedelta(days=364)).isoformat(),
            "employees": [{"id": e} for e in range(20)],
            "employeeHolidays": [[d.isoformat() for d in hols[e]] for e in range(20)],
            "population": 64, "proposer": "random",
        }, hols, max_rounds=6)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return f"7x31: {small}; 365x20 P=64 random: {large}"


def phase_gpu_tests():
    """The tests marked ``gpu`` (they skip on a machine without one),
    loaded from their files: the Triton nqueens kernel as compiled for the
    card against the XLA path at real widths, and QAP's exact incremental
    update."""
    import importlib.util

    names = []
    for stem in GPU_TEST_MODULES:
        path = os.path.join(REPO, "tests", f"{stem}.py")
        spec = importlib.util.spec_from_file_location(f"_gpu_{stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        for name in sorted(dir(module)):
            fn = getattr(module, name)
            marks = getattr(fn, "pytestmark", [])
            if name.startswith("test_") and any(m.name == "gpu" for m in marks):
                fn()
                names.append(f"{stem}::{name}")
    if len(names) < len(GPU_TEST_MODULES):
        raise AssertionError(f"gpu-marked tests missing: found {names}")
    return "passed " + ", ".join(names)


# -- four-card phase ------------------------------------------------------

def phase_four_cards(nq_n: int = 4096, days: int = 365, emps: int = 20):
    """ShardedPopulationSolver on nqueens-4096 over Mesh(pop=2, nbr=2), and
    the dense scheduling 365x20 population sharded over pop=4, each against
    the same seed on one card.  (The sizes are arguments only so that the
    path can be rehearsed small on virtual CPU devices.)"""
    from constraint_solver_tpu.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu.parallel.mesh import make_mesh
    from constraint_solver_tpu.parallel.population import PopulationSolver
    from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver

    import jax

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX found {jax.devices()}")
    out = []
    # One card first: a mesh solver sets the ambient mesh for what follows.
    one_nq = PopulationSolver(make_nqueens_problem(nq_n, sample_cols=64),
                              nq_config("four"), population=8, exchange_every=2)
    one_nq.run(max_rounds=400, chunk=2)
    one_sched = dense_sched_solver(64, days=days, emps=emps)
    one_sched.run(max_rounds=8, chunk=4)
    one_nq_hard = check_nqueens(one_nq, want_zero=True)
    one_sched_score = check_scheduling(one_sched, days, emps)

    sharded = ShardedPopulationSolver(
        make_nqueens_problem(nq_n, sample_cols=64, nbr_axis="nbr", nbr_shards=2),
        nq_config("four"), population=8, exchange_every=2,
        mesh=make_mesh(n_pop=2, n_nbr=2),
    )
    sharded.run(max_rounds=400, chunk=2)
    check_equal(f"nqueens-{nq_n} (2x2 mesh vs one card)",
                check_nqueens(sharded, want_zero=True), one_nq_hard)
    out.append(f"nqueens-{nq_n} Mesh(pop=2,nbr=2): best=0 in "
               f"{sharded.stats()['rounds']} rounds (one card: "
               f"{one_nq.stats()['rounds']} rounds)")

    pop4 = dense_sched_solver(64, mesh=make_mesh(n_pop=4, n_nbr=1),
                              days=days, emps=emps)
    pop4.run(max_rounds=8, chunk=4)
    check_equal(f"scheduling {days}x{emps} (pop=4 vs one card)",
                check_scheduling(pop4, days, emps), one_sched_score)
    out.append(f"scheduling-{days}x{emps} dense P=64 over pop=4: "
               f"best={pop4.get_best_solution()[0]} == one card")
    return "; ".join(out)


ONE_CARD_PHASES = [
    ("nqueens1000_P256", phase_nqueens1000),
    ("nqueens16384_P16_A64", phase_nqueens16384),
    ("scheduling365x20_dense_P64", phase_scheduling_dense),
    ("scheduling365x20_random_P128", phase_scheduling_random),
    ("qap1024_cli", phase_qap1024),
    ("qap4096_cli", phase_qap4096),
    ("server_sessions", phase_server),
    ("gpu_tests", phase_gpu_tests),
]
FOUR_CARD_PHASES = [("four_cards", phase_four_cards)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-GPU sharded phases only")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU, JAX found {devices}", file=sys.stderr)
        return 2
    cache = compile_cache.enable()
    log(f"card: {card_name_and_power_limit()}")
    log(f"jax {jax.__version__}, devices {devices}")
    log(f"compile cache: {cache}")
    for name, fn in FOUR_CARD_PHASES if args.four else ONE_CARD_PHASES:
        t0 = time.perf_counter()
        detail = fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s: {detail}")
    stats = devices[0].memory_stats() or {}
    log(f"peak device memory: {stats.get('peak_bytes_in_use', 'n/a')} bytes")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
