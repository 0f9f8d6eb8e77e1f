"""End-to-end A/B of the nqueens [A, n] block on a GPU.

The Triton-route kernel (what ``make_nqueens_problem`` picks on a GPU)
against the XLA ``block_scores`` path, alternating in one process in the
order xla, kernel, kernel, xla.  Both give bit-equal scores, so one seed
takes the same trajectory in both arms and the LS iteration counts match;
only the wall differs.  Reports moves/s (LS iterations x candidates per
iteration / wall) per arm and window.

nqueens-1000 (P=256, A=50) solves in about two rounds, a fraction of a
second, so each of its windows chains ``--solves`` seeded solves.
nqueens-16384 (P=16, A=64) runs ``--big-rounds`` rounds per window.

    python bench/nqueens_block_ab.py [--windows 2] [--solves 12] [--big-rounds 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import constraint_solver_tpu.models.nqueens as nq  # noqa: E402
from constraint_solver_tpu.core.ils import SolverConfig  # noqa: E402
from constraint_solver_tpu.parallel.population import PopulationSolver  # noqa: E402
from constraint_solver_tpu.utils import compile_cache  # noqa: E402
from constraint_solver_tpu.utils.oracles import nqueens_conflicts  # noqa: E402

# The benchmark's nqueens configuration (bench.py).
CONFIG = dict(
    local_search_max_iterations=250,
    all_solutions_capacity=256,
    best_solutions_capacity=8,
    iterated_local_search_max_iterations=10_000,
    max_allow_no_improvement_for=5,
)
ORDER = ("xla", "kernel", "kernel", "xla")


def arm_problem(impl: str, n: int, a: int | None):
    """An uncached problem whose block is the kernel or the XLA path; the
    choice is fixed when its programs are first traced."""
    block = nq.nqueens_block_kernel if impl == "kernel" else nq.block_scores
    with mock.patch.object(nq, "nqueens_block_kernel", block):
        return nq.make_nqueens_problem.__wrapped__(n, sample_cols=a), block


def window(problem, block, pop: int, seeds: list[str], rounds: int | None):
    """Run one seeded solve per seed; returns (LS iterations, wall s)."""
    iters, wall = 0, 0.0
    with mock.patch.object(nq, "nqueens_block_kernel", block):
        for seed in seeds:
            s = PopulationSolver(problem, SolverConfig(seed=seed, **CONFIG),
                                 population=pop, exchange_every=2)
            t = time.perf_counter()
            s.run(chunk=2) if rounds is None else s.run(max_rounds=rounds, chunk=2)
            wall += time.perf_counter() - t
            (hard, _), st = s.get_best_solution()
            if hard != nqueens_conflicts(st.rows):
                raise AssertionError(f"best {hard} != host rescore")
            iters += s.stats()["ls_iterations"]
    return iters, wall


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=2)
    parser.add_argument("--solves", type=int, default=12)
    parser.add_argument("--big-rounds", type=int, default=20)
    args = parser.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("nqueens_block_ab: needs a GPU", file=sys.stderr)
        return 2
    compile_cache.enable()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    cells = [("nqueens-1000 P=256", 1000, None, 256, None, args.solves),
             ("nqueens-16384 P=16 A=64", 16384, 64, 16, args.big_rounds, 1)]
    results = {}
    for name, n, a, pop, rounds, solves in cells:
        arms = {impl: arm_problem(impl, n, a) for impl in ("xla", "kernel")}
        for impl, (problem, block) in arms.items():  # compile both arms
            window(problem, block, pop, ["warm"], 2)
        for w in range(args.windows):
            seeds = [f"ab{w}-{k}" for k in range(solves)]
            for impl in ORDER:
                iters, wall = window(*arms[impl], pop, seeds, rounds)
                mps = iters * arms[impl][0].width / wall
                results.setdefault(name, {}).setdefault(impl, []).append(mps)
                print(f"{name} window {w} {impl}: {iters} LS iterations in "
                      f"{wall:.4f} s -> {mps:.5g} moves/s", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
