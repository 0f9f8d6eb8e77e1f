"""Round-4 scheduling quality-at-wall sweep with variance discipline.

Measures BOTH sides of the north-star race (best score at 2.3/10/60 s wall
on scheduling-365d-20e) with >= 3 fresh-state repeats per side:

- baseline: the complete reference-algorithm C++ binary
  (bench/baseline_full.cc), seeds 42/43/44;
- device: candidate production configurations, seeds b0/b1/b2, probed EVERY
  round for the first PROBE_FINE rounds (quantifying the chunk-boundary
  probe lag at the 2.3 s budget) and every 2 rounds after.

The dense block's global-argmin descent is maximally exploitative but
diffuses poorly along the soft plateau, while the reference's W=100
random-window noisy descent crosses it.  Hence the
"randlate" phase schedules: dense early (hard+soft crushed fast), then the
reference-shaped random proposer late — every lane runs the baseline's own
algorithm at a multiple of its iteration rate, times P lanes with elite
exchange.

Prints per-config per-budget [median, worst] and the gate verdict
(median device <= median baseline at every budget).

Run (GPU, one process): python -u bench/sched_quality_r4.py
Env: R4_BUDGETS, R4_REPS, R4_CONFIGS (csv of names), R4_POP.
"""

import datetime
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGETS = [float(b) for b in os.environ.get("R4_BUDGETS", "2.3,10,60").split(",")]
REPS = int(os.environ.get("R4_REPS", 3))
POP = int(os.environ.get("R4_POP", 64))
DAYS = int(os.environ.get("R4_DAYS", 365))
EMPS = int(os.environ.get("R4_EMPS", 20))
if os.environ.get("R4_CPU"):  # smoke-test mode on the host backend
    import jax
    jax.config.update("jax_platforms", "cpu")

PROBE_FINE = 16  # probe every round below this round count, every 2 after
_DIR = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def median_worst(scores):
    """Scores are (hard, soft) tuples; lexicographic median and worst."""
    s = sorted(scores)
    return s[len(s) // 2], s[-1]


def run_baseline(seed):
    exe = os.path.join(_DIR, os.pardir, "build", "baseline_full")
    os.makedirs(os.path.dirname(exe), exist_ok=True)
    src = os.path.join(_DIR, "baseline_full.cc")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(["g++", "-O3", "-march=native", "-o", exe, src],
                       check=True, capture_output=True, timeout=180)
    budget_str = ",".join(str(b) for b in BUDGETS)
    out = subprocess.run(
        [exe, "scheduling", str(DAYS), str(EMPS), budget_str, str(seed), "1", "0"],
        check=True, capture_output=True, timeout=max(BUDGETS) + 60)
    d = json.loads(out.stdout.strip())
    return [(h, s) for h, s in zip(d["best_hard"], d["best_soft"])]


# A phase: (until_round|None, proposer_kwargs, ls, bail).
DENSE = dict(proposer="dense", n_rand_swaps=256)
RAND = dict(proposer="random", window_size=100)
RAND256 = dict(proposer="random", window_size=256)

CONFIGS = {
    "randonly": [(None, RAND, 1000, 20)],
    "randlate36": [(36, DENSE, 200, 20), (None, RAND, 1000, 20)],
    "randlate72": [(72, DENSE, 200, 20), (None, RAND, 1000, 20)],
    "rand256late36": [(36, DENSE, 200, 20), (None, RAND256, 1000, 20)],
}


def main():
    # ---- baseline side, 3 seeds --------------------------------------------
    base_runs = []
    for seed in (42, 43, 44):
        r = run_baseline(seed)
        base_runs.append(r)
        log(f"baseline seed={seed}: {r}")
    base_med = [median_worst([run[i] for run in base_runs])[0]
                for i in range(len(BUDGETS))]
    base_worst = [median_worst([run[i] for run in base_runs])[1]
                  for i in range(len(BUDGETS))]
    log(f"baseline median={base_med} worst={base_worst}")

    # ---- device side -------------------------------------------------------
    from constraint_solver_tpu.core.ils import SolverConfig
    from constraint_solver_tpu.models.scheduling import (
        ScheduleSpec, make_scheduling_problem)
    from constraint_solver_tpu.parallel.population import PopulationSolver

    d0 = datetime.date(2024, 1, 1)
    spec = ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=DAYS - 1), EMPS,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % DAYS)
             for k in range(10)] for e in range(EMPS)})

    problems = {}

    def prob(kwargs):
        k = tuple(sorted(kwargs.items()))
        if k not in problems:
            problems[k] = make_scheduling_problem(spec, **kwargs)
        return problems[k]

    def cfg(ls, bail, seed):
        return SolverConfig(
            seed=seed, local_search_max_iterations=ls,
            best_solutions_capacity=16, all_solutions_capacity=256,
            all_solution_iteration_expiry=1_000,
            iterated_local_search_max_iterations=100_000,
            max_allow_no_improvement_for=bail)

    configs = CONFIGS
    names = os.environ.get("R4_CONFIGS")
    if names:
        configs = {n: CONFIGS[n] for n in names.split(",")}

    # Warm every (problem, config, chunk) program outside the clock.
    warmed = set()

    def warm(phase):
        _, pk, ls, bail = phase
        for chunk in (1, 2):
            k = (tuple(sorted(pk.items())), ls, bail, chunk)
            if k in warmed:
                continue
            t0 = time.time()
            w = PopulationSolver(prob(pk), cfg(ls, bail, "warm"),
                                 population=POP, exchange_every=2)
            w.state = w._chunk_jit(w.state, chunk)
            w.get_best_score()
            log(f"warm {k}: {time.time() - t0:.1f}s")
            warmed.add(k)

    for phases in configs.values():
        for ph in phases:
            warm(ph)

    results = {}
    for name, phases in configs.items():
        runs = []
        for rep in range(REPS):
            seed = f"b{rep}"
            t_mk = time.time()
            solvers = [
                PopulationSolver(prob(pk), cfg(ls, bail, seed),
                                 population=POP, exchange_every=2)
                for (_, pk, ls, bail) in phases]
            log(f"  [{name} rep={rep}] solver create {time.time() - t_mk:.1f}s")
            s = solvers[0]
            phase_i = 0
            at = []
            bi = 0
            rounds = 0
            traj = []
            t0 = time.time()
            while bi < len(BUDGETS):
                chunk = 1 if rounds < PROBE_FINE else 2
                s.state = s._chunk_jit(s.state, chunk)
                rounds += chunk
                until = phases[phase_i][0]
                if until is not None and rounds >= until:
                    solvers[phase_i + 1].state = s.state
                    s = solvers[phase_i + 1]
                    phase_i += 1
                best = s.get_best_score()
                el = time.time() - t0
                if not traj or traj[-1][1] != best:
                    traj.append((round(el, 2), best))
                while bi < len(BUDGETS) and el >= BUDGETS[bi]:
                    at.append(best)
                    bi += 1
            runs.append(at)
            log(f"{name} rep={rep}: {at} rounds={rounds}")
            log(f"  traj: {traj}")
            t_del = time.time()
            del solvers, s
            log(f"  [teardown {time.time() - t_del:.1f}s]")
        med = [median_worst([r[i] for r in runs])[0] for i in range(len(BUDGETS))]
        worst = [median_worst([r[i] for r in runs])[1] for i in range(len(BUDGETS))]
        ok = all(m <= b for m, b in zip(med, base_med))
        results[name] = {"median": med, "worst": worst, "ok": ok}
        log(f"== {name}: median={med} worst={worst} "
            f"gate={'WIN' if ok else 'lose'} (baseline median {base_med})")

    log("SUMMARY " + json.dumps({
        "budgets": BUDGETS,
        "baseline_median": base_med, "baseline_worst": base_worst,
        "configs": results}))


if __name__ == "__main__":
    main()
