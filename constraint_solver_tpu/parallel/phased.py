"""Phase-scheduled population solver: different engine programs over one
population state as the search progresses.

The reference cannot express this — its engine parameters are fixed for the
whole run (reference local-search/src/iterated_local_search.rs:96-155) — but
the device engine's ``IlsState`` pytree is *program-independent*: engine
parameters (ls_max, bail, neighborhood shape, even the PROPOSER) are
trace-time constants, not state, so switching programs mid-run is a plain
handoff of the same arrays to a different compiled executable.
``PhasedPopulationSolver`` packages that handoff behind the standard driver
API.

Role (quality sweeps on earlier hardware): phase schedules
mixing the dense-argmin proposer with the reference-shaped random-window
proposer were the instrument that localized the scheduling quality gap —
the sweep's verdict was that the random-window program wins the race at
EVERY wall budget, so the production quality mode is single-phase and this
class is the general mechanism (e.g. dense hard-phase -> random soft-phase
schedules on instances where the hard descent dominates the early wall).

Phase boundaries are ROUND counts (not wall clock): trajectories stay
deterministic per seed regardless of host timing jitter.

Constraints on a valid phase list (checked at construction):
- every phase's elite/tabu capacities and tabu expiry match (they shape the
  state pytree — a mismatch would hand arrays to a program traced for a
  different structure);
- every phase's problem has the same solution-state pytree structure
  (neighborhood WIDTH may differ freely — it is trace-time).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.core.problem import Problem
from constraint_solver_tpu.parallel.population import PopulationSolver


class Phase(NamedTuple):
    """One phase: run ``problem``/``config`` until the population's round
    counter reaches ``until_round`` (None = until the overall budget)."""

    problem: Problem
    config: SolverConfig
    until_round: int | None = None


class PhasedPopulationSolver:
    """Same driver API as ``PopulationSolver`` over a phase schedule.

    The total round budget is the LAST phase's
    ``iterated_local_search_max_iterations``; earlier phases end at their
    ``until_round``.  All phases share one population state; metrics
    (moves evaluated) are accumulated per phase because the neighborhood
    width may differ between phases.
    """

    def __init__(self, phases: list[Phase], population: int,
                 exchange_every: int = 10, k_exchange: int = 4,
                 mesh=None, portfolio: str = "reference",
                 cull_frac: float = 0.0, cull_rank: str = "lex"):
        if not phases:
            raise ValueError("need at least one phase")
        caps = [(p.config.best_solutions_capacity,
                 p.config.all_solutions_capacity,
                 p.config.all_solution_iteration_expiry) for p in phases]
        if len(set(caps)) != 1:
            raise ValueError(
                f"phases disagree on state-shaping capacities: {caps}")
        for p in phases[:-1]:
            if p.until_round is None:
                raise ValueError("only the last phase may omit until_round")
        bounds = [p.until_round for p in phases[:-1]]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"phase until_rounds must increase: {bounds}")
        self.phases = phases
        self.population = population
        self.cancelled = False
        self._wall = 0.0
        # One PopulationSolver per phase; the program cache
        # (parallel/population.py) dedupes compilation across instances.
        self._solvers = [
            PopulationSolver(p.problem, p.config, population,
                             exchange_every=exchange_every,
                             k_exchange=k_exchange, mesh=mesh,
                             portfolio=portfolio, cull_frac=cull_frac,
                             cull_rank=cull_rank)
            for p in phases]
        # All phases run on phase 0's initial state.
        self.state = self._solvers[0].state
        # Moves evaluated in COMPLETED phases + the iteration count at each
        # phase entry (widths differ per phase).
        self._moves_done = 0
        self._iters_at_entry = 0

    # -- phase bookkeeping -------------------------------------------------

    def _phase_index(self, rounds: int) -> int:
        for i, p in enumerate(self.phases[:-1]):
            if rounds < p.until_round:
                return i
        return len(self.phases) - 1

    @property
    def _active(self) -> PopulationSolver:
        return self._solvers[self._phase_index(self._round_count())]

    def _round_count(self) -> int:
        s = self._solvers[0]
        return int(np.asarray(s._probe_jit(self.state)[0]))

    def _iters(self) -> int:
        s = self._solvers[0]
        return int(np.asarray(s._probe_jit(self.state)[1]))

    # -- driver API (mirrors PopulationSolver) -----------------------------

    def execute_round(self) -> None:
        r0 = self._round_count()
        pi = self._phase_index(r0)
        a = self._solvers[pi]
        a.state = self.state
        a.execute_round()
        self.state = a.state
        if self._phase_index(r0 + 1) != pi:
            # Phase boundary crossed via per-tick stepping: bank the
            # completed phase's moves at ITS width, exactly as run() does —
            # otherwise stats() would price every unbanked earlier-phase
            # iteration at the current phase's width (ADVICE.md round 4).
            it = self._iters()
            self._moves_done += (it - self._iters_at_entry) * \
                self.phases[pi].problem.width
            self._iters_at_entry = it

    def is_finished(self) -> bool:
        total = self.phases[-1].config.iterated_local_search_max_iterations
        return self._round_count() >= total

    def get_iteration_info(self) -> dict:
        return {
            "current": self._round_count(),
            "total": self.phases[-1].config.iterated_local_search_max_iterations,
        }

    def get_best_score(self) -> tuple:
        a = self._solvers[0]
        score = np.asarray(a._best_score_jit(self.state))
        return (float(score[0]), float(score[1]))

    def get_best_solution(self):
        a = self._solvers[0]
        import jax

        score, state = a._global_best_jit(self.state)
        score = np.asarray(score)
        state = jax.tree.map(np.asarray, state)
        return (float(score[0]), float(score[1])), state

    def cancel(self) -> None:
        self.cancelled = True

    def run(self, max_rounds: int | None = None, chunk: int | None = None,
            verbose: bool = False, checkpoint_path: str | None = None,
            checkpoint_every: int = 200) -> None:
        """Dispatch chunks of the ACTIVE phase's program; chunks never cross
        a phase boundary (the boundary round is exact, so trajectories are
        reproducible for a given phase schedule + seed)."""
        total = self.phases[-1].config.iterated_local_search_max_iterations
        rounds = self._round_count()
        if max_rounds is not None:
            total = min(total, rounds + max_rounds)
        last_ckpt = rounds
        t0 = time.time()
        while not self.cancelled and rounds < total:
            pi = self._phase_index(rounds)
            solver = self._solvers[pi]
            phase_end = (self.phases[pi].until_round
                         if pi < len(self.phases) - 1 else total)
            n = min(chunk or solver.exchange_every, phase_end - rounds,
                    total - rounds)
            prev_pi = pi
            solver.state = self.state
            self.state = solver._chunk_jit(self.state, n)
            rounds += n
            if self._phase_index(rounds) != prev_pi:
                # Phase completed: bank its moves at its own width.
                it = self._iters()
                self._moves_done += (it - self._iters_at_entry) * \
                    self.phases[prev_pi].problem.width
                self._iters_at_entry = it
            score = jnp.asarray(self._solvers[0]._best_score_jit(self.state))
            if verbose:
                print(f"[phased x P{self.population}] round {rounds}/{total} "
                      f"phase {self._phase_index(rounds)} "
                      f"best score: ({score[0]}, {score[1]})")
            if checkpoint_path and rounds - last_ckpt >= checkpoint_every:
                self.save(checkpoint_path)
                last_ckpt = rounds
            # Solved-early exit judged by the ACTIVE phase's problem (phases
            # may differ in is_best semantics — ADVICE.md round 4).
            if bool(self.phases[self._phase_index(rounds)].problem
                    .is_best(score)):
                break
        self._wall += time.time() - t0
        if checkpoint_path:
            self.save(checkpoint_path)

    def stats(self) -> dict:
        rounds = self._round_count()
        iters = self._iters()
        pi = self._phase_index(rounds)
        moves = self._moves_done + \
            (iters - self._iters_at_entry) * self.phases[pi].problem.width
        out = {
            "rounds": rounds,
            "population": self.population,
            "phase": pi,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": int(
                np.sum(np.asarray(self.state.tabu_exhausted_total))),
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out

    # -- checkpoint / resume ----------------------------------------------

    def save(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import save_state

        save_state(path, self.state, {
            "problem": self.phases[0].problem.name,
            "seed": self.phases[0].config.seed,
            "population": self.population,
            "phased_moves_done": self._moves_done,
            "phased_iters_at_entry": self._iters_at_entry,
        })

    def load(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import load_state

        self.state, meta = load_state(path, self.state)
        if meta.get("problem") != self.phases[0].problem.name:
            raise ValueError(
                f"checkpoint is for {meta.get('problem')}, "
                f"solver is {self.phases[0].problem.name}")
        if meta.get("population", 1) != self.population:
            raise ValueError(
                f"checkpoint is for population={meta.get('population', 1)}, "
                f"solver has population={self.population}")
        if np.unique(np.asarray(self.state.round)).size != 1:
            raise ValueError(
                "checkpoint violates the lane-lockstep round invariant "
                f"(rounds {np.unique(np.asarray(self.state.round))})")
        # Resume re-enters the correct phase automatically (phase index is a
        # pure function of the round counter); per-phase move accounting is
        # restored from the checkpoint metadata.
        self._moves_done = int(meta.get("phased_moves_done", 0))
        self._iters_at_entry = int(meta.get("phased_iters_at_entry", 0))
