"""Iterated Local Search engine and round-based driver.

Accelerator re-design of the reference ``IteratedLocalSearch``
(reference local-search/src/iterated_local_search.rs:96-203), preserving the
round semantics of ``execute_round`` (ref :173-202):

1. increment the round counter;
2. if the elite best already satisfies ``is_best`` → the round is a no-op
   (ref :175-184); the inner local search is gated off so converged
   trajectories cost ~nothing;
3. every ``restart_every`` (= 50, ref :185-191) rounds, replace ``current``
   with a fresh random solution;
4. perturb ``current`` (intensify if it is an elite, diversify otherwise);
5. run the inner local-search descent;
6. insert the descent result into the elite archive (ref :198);
7. acceptance: score-blind weighted random choice among {current: 1,
   new: 5, random elite: 1} (ref AcceptanceCriterion::choose, :51-71).

The whole round is one jitted pure function ``IlsState -> IlsState`` — it
``lax.scan``s over rounds, ``vmap``s over trajectory populations, and shards
over device meshes.  The host-facing ``Solver`` class mirrors the reference's
wasm round-based contract: step / is_finished / best / progress / cancel
(reference web/employee-scheduling-wasm-bindgen/src/lib.rs:19-84).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from types import SimpleNamespace
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.history import EliteArchive, TabuRing
from constraint_solver_tpu.core.local_search import LsParams, _select, ls_execute
from constraint_solver_tpu.core.problem import Problem
from constraint_solver_tpu.ops.lex import lex_leq
from constraint_solver_tpu.utils.seeding import seed_string_to_key


class IlsParams(NamedTuple):
    max_iterations: int
    max_allow_no_improvement_for: int
    restart_every: int = 50  # ref iterated_local_search.rs:185
    # Acceptance weights {current, new, random-elite} (ref :62-69).
    accept_weights: tuple = (1.0, 5.0, 1.0)


class IlsState(NamedTuple):
    current_state: Any
    current_score: jax.Array  # float32[2]
    current_fp: jax.Array     # uint32[2]
    elite: EliteArchive
    tabu: TabuRing
    round: jax.Array          # int32[]
    ls_iters_total: jax.Array  # int32[] total inner LS iterations (metrics)
    # int32[] iterations where the tabu pick-then-check retry budget ran
    # out with valid candidates left (measured divergence, docs/DESIGN.md).
    tabu_exhausted_total: jax.Array
    key: jax.Array
    # Acceptance mode knob (a per-trajectory portfolio parameter):
    #   < 0  — the reference's score-blind weighted random choice
    #          {current: 1, new: 5, random elite: 1} (ref :51-71);
    #   == 0 — greedy: keep the lexicographically better of current/new;
    #   > 0  — simulated-annealing Metropolis on the hard channel with this
    #          temperature.
    accept_temp: jax.Array    # float32[]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Engine hyperparameters, mirroring the reference ``MainArgs``
    (reference examples/employee-scheduling/src/lib.rs:35-48 and
    examples/nqueens/src/main.rs:16-26).  ``window_size`` lives with the
    problem factory (it shapes the neighborhood tensor)."""

    seed: str = "42"
    local_search_max_iterations: int = 10_000
    best_solutions_capacity: int = 32
    all_solutions_capacity: int = 512  # tabu ring size (dense, so kept small)
    all_solution_iteration_expiry: int = 10_000
    iterated_local_search_max_iterations: int = 10_000
    max_allow_no_improvement_for: int = 5
    restart_every: int = 50
    # Tabu resolution: None = auto (the reference-exact [W, T] filter when
    # width * ring fits the budget below, else pick-then-check — see
    # LsParams.tabu_exact_filter); True/False forces a mode.
    tabu_exact_filter: bool | None = None
    # Noisy dense selection (LsParams.select_topk / select_temp): sample
    # the applied move from the top-k candidates instead of the argmin.
    # 0 = exact argmin (the default, bit-identical to previous rounds).
    select_topk: int = 0
    select_temp: float = 1.0

    # Exact-filter auto threshold: candidate-width x ring-capacity compares
    # per iteration.  2^21 keeps the membership matrix in the same cost
    # class as the candidate block itself for the small-W domains that
    # need it (scheduling: the pick-then-check budget exhausted on 59.8%
    # of iterations, bench/tabu_exhaustion.py at commit 9d1252d) while
    # leaving the 50k-wide nqueens block (0 retries counted) on the cheap
    # path.
    _EXACT_FILTER_BUDGET = 2**21

    def ls_params(self, problem_width: int | None = None) -> LsParams:
        if self.tabu_exact_filter is not None:
            exact = self.tabu_exact_filter
        else:
            exact = (
                problem_width is not None
                and 0 < problem_width * self.all_solutions_capacity
                <= self._EXACT_FILTER_BUDGET
            )
        return LsParams(
            max_iterations=self.local_search_max_iterations,
            allow_no_improvement_for=self.max_allow_no_improvement_for,
            select_topk=self.select_topk,
            select_temp=self.select_temp,
            tabu_exact_filter=exact,
            # A user-forced mode (True/False) must win even over proposers
            # that provide free dense fingerprints (a pick-then-check A/B
            # depends on forcing False).
            tabu_forced=self.tabu_exact_filter is not None,
        )

    def ils_params(self) -> IlsParams:
        return IlsParams(
            max_iterations=self.iterated_local_search_max_iterations,
            max_allow_no_improvement_for=self.max_allow_no_improvement_for,
            restart_every=self.restart_every,
        )


def ils_init(
    problem: Problem,
    config: SolverConfig,
    key: jax.Array,
    accept_temp: float = -1.0,
) -> IlsState:
    """Build the initial ILS state: a scored random solution (ref
    IteratedLocalSearch::new, iterated_local_search.rs:141-155), an empty
    elite archive, and an empty tabu ring."""
    key, k_init = jax.random.split(key)
    state = problem.init(k_init)
    score = problem.score(state)
    fp = problem.fingerprint(state)
    return IlsState(
        current_state=state,
        current_score=score,
        current_fp=fp,
        elite=EliteArchive.create(config.best_solutions_capacity, state),
        tabu=TabuRing.create(
            config.all_solutions_capacity, config.all_solution_iteration_expiry
        ),
        round=jnp.int32(0),
        ls_iters_total=jnp.int32(0),
        tabu_exhausted_total=jnp.int32(0),
        key=key,
        accept_temp=jnp.float32(accept_temp),
    )


def ils_round(
    problem: Problem,
    ls_params: LsParams,
    ils_params: IlsParams,
    st: IlsState,
    round_scalar: jax.Array | None = None,
) -> IlsState:
    """One ILS round (ref execute_round, iterated_local_search.rs:173-202).

    ``round_scalar``: the 1-based round number this call executes, as an
    UNBATCHED scalar.  Lane round counters advance in lockstep (every lane's
    ``round`` increments every call, converged or not), so chunk drivers can
    thread the loop index here and the every-``restart_every`` random restart
    compiles to a real ``lax.cond`` branch — the O(n^2) ``problem.init`` is
    then only computed on the 1-in-50 rounds that restart, instead of being
    computed and discarded by a select on every round.  ``None`` falls back
    to the per-lane select (same trajectories, more work per round).
    """
    rnd = st.round + 1  # ref :174 — increments even on the early-exit path

    # Early-exit check against the elite best (ref :175-184).
    best_score, _, _ = st.elite.get_best()
    has_elite = jnp.any(st.elite.valid)
    done = has_elite & problem.is_best(best_score)

    key, k_restart, k_perturb, k_ls, k_accept_elite, k_accept = jax.random.split(
        st.key, 6
    )

    # Full random restart every `restart_every` rounds (ref :185-191).
    def do_restart(_):
        fresh_state = problem.init(k_restart)
        return (
            fresh_state,
            problem.score(fresh_state),
            problem.fingerprint(fresh_state),
        )

    def no_restart(_):
        return st.current_state, st.current_score, st.current_fp

    if round_scalar is None:
        restart = (rnd % ils_params.restart_every) == 0
        fresh_state, fresh_score, fresh_fp = do_restart(None)
        cur_state = _select(restart, fresh_state, st.current_state)
        cur_score = jnp.where(restart, fresh_score, st.current_score)
        cur_fp = jnp.where(restart, fresh_fp, st.current_fp)
    else:
        restart_s = (round_scalar % ils_params.restart_every) == 0
        cur_state, cur_score, cur_fp = jax.lax.cond(
            restart_s, do_restart, no_restart, None
        )

    # Perturbation (ref :192-194), intensify near elites / diversify otherwise
    # (e.g. nqueens lib.rs:304-307).
    is_elite = st.elite.contains_fp(cur_fp)
    perturbed = problem.perturb(cur_state, is_elite, k_perturb)

    # Inner descent (ref :195-197); gated off for converged trajectories.
    new_state, new_score, tabu, ls_iters, ls_exhausted = ls_execute(
        problem, ls_params, perturbed, st.tabu, k_ls, enabled=~done
    )
    new_fp = problem.fingerprint(new_state)

    # Elite archive insert (ref :198).
    elite = st.elite.insert(new_score, new_fp, new_state)

    # Acceptance.  Reference mode (accept_temp < 0): score-blind weighted
    # choice {current:1, new:5, elite:1} (ref AcceptanceCriterion::choose,
    # :51-71) — the elite archive is never empty here because the insert
    # above precedes the choice.  Portfolio modes: greedy (temp == 0) and
    # SA-Metropolis on the hard channel (temp > 0).
    e_score, e_fp, e_state = elite.get_random(k_accept_elite)
    w = jnp.asarray(ils_params.accept_weights, jnp.float32)
    choice3 = jax.random.choice(k_accept, 3, p=w / w.sum())

    temp = st.accept_temp
    d_hard = new_score[0] - cur_score[0]
    p_metropolis = jnp.where(
        temp > 0.0, jnp.exp(-jnp.maximum(d_hard, 0.0) / jnp.maximum(temp, 1e-9)), 0.0
    )
    sa_take_new = lex_leq(new_score, cur_score) | (
        jax.random.uniform(k_accept) < p_metropolis
    )
    # choice: 0 = current, 1 = new, 2 = random elite
    choice = jnp.where(temp < 0.0, choice3, jnp.where(sa_take_new, 1, 0))
    nxt_state = _select(
        choice == 0, cur_state, _select(choice == 1, new_state, e_state)
    )
    nxt_score = jnp.where(
        choice == 0, cur_score, jnp.where(choice == 1, new_score, e_score)
    )
    nxt_fp = jnp.where(choice == 0, cur_fp, jnp.where(choice == 1, new_fp, e_fp))

    out = IlsState(
        current_state=nxt_state,
        current_score=nxt_score,
        current_fp=nxt_fp,
        elite=elite,
        tabu=tabu,
        round=rnd,
        ls_iters_total=st.ls_iters_total + ls_iters,
        tabu_exhausted_total=st.tabu_exhausted_total + ls_exhausted,
        key=key,
        accept_temp=st.accept_temp,
    )
    # Converged trajectories only advance their round counter and key.
    return _select(done, st._replace(round=rnd, key=key), out)


@lru_cache(maxsize=64)
def _solver_programs(problem: Problem, ls_params: LsParams, ils_params: IlsParams):
    """Jitted single-trajectory programs, shared across Solver instances —
    re-creating a solver with the same problem/params must not re-trace or
    re-compile (compilation dominated measured solve walls otherwise)."""
    round_fn = partial(ils_round, problem, ls_params, ils_params)

    def run_chunk(st: IlsState, n: int) -> IlsState:
        # Thread the loop round number as a scalar so the every-50-rounds
        # restart is a real branch (see ils_round round_scalar).
        base = st.round
        return jax.lax.fori_loop(
            0, n, lambda i, s: round_fn(s, round_scalar=base + 1 + i), st
        )

    return SimpleNamespace(
        round=jax.jit(round_fn),
        chunk=jax.jit(run_chunk, static_argnums=1),
        # Cheap convergence probe: transfers 8 bytes, not the elite arrays.
        best_score=jax.jit(lambda st: st.elite.get_best()[0]),
    )


class Solver:
    """Round-based host driver.

    The API mirrors the reference wasm bridge + web-worker contract —
    incremental, cancellable, progress-reporting solving with per-round
    stepping (reference web/employee-scheduling-wasm-bindgen/src/lib.rs:55-84
    and web/employee-scheduling/src/worker.ts:7-27):

    - ``execute_round()``   — one ILS round on device
    - ``run(chunk=...)``    — scan many rounds per device call (fast path)
    - ``is_finished()``     — round budget exhausted
    - ``get_best_solution()`` / ``get_iteration_info()`` / ``cancel()``
    """

    def __init__(self, problem: Problem, config: SolverConfig):
        self.problem = problem
        self.config = config
        self.cancelled = False
        self._wall = 0.0
        key = seed_string_to_key(config.seed)
        self.state = ils_init(problem, config, key)
        progs = _solver_programs(
            problem, config.ls_params(problem.width), config.ils_params()
        )
        self._round_jit = progs.round
        self._chunk_jit = progs.chunk
        self._best_score_jit = progs.best_score

    # -- wasm-bridge-shaped API ------------------------------------------

    def execute_round(self) -> None:
        self.state = self._round_jit(self.state)

    def is_finished(self) -> bool:
        return int(self.state.round) >= self.config.iterated_local_search_max_iterations

    def get_iteration_info(self) -> dict:
        return {
            "current": int(self.state.round),
            "total": self.config.iterated_local_search_max_iterations,
        }

    def get_best_solution(self):
        """Returns ``(score, state)`` with score a (hard, soft) float tuple
        and state as host numpy arrays."""
        score, _, state = self.state.elite.get_best()
        score = np.asarray(score)
        return (float(score[0]), float(score[1])), jax.tree.map(np.asarray, state)

    def get_best_score(self) -> tuple:
        """(hard, soft) of the archive best — transfers 8 bytes, not the
        solution tensors (quality-at-wall probes call this every chunk)."""
        score = np.asarray(self.state.elite.get_best()[0])
        return (float(score[0]), float(score[1]))

    def cancel(self) -> None:
        self.cancelled = True

    # -- fast path --------------------------------------------------------

    def run(
        self,
        max_rounds: int | None = None,
        chunk: int = 16,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 200,
    ) -> None:
        """Run rounds until finished/converged/cancelled.  ``chunk`` rounds
        execute per device dispatch; between chunks the host checks
        convergence (the reference's per-round host loop, amortized).
        ``verbose`` logs the best score per chunk, the analog of the
        reference's per-round progress print (iterated_local_search.rs:176-179).
        With ``checkpoint_path``, the full solver state is snapshotted every
        ``checkpoint_every`` rounds — the restartable-outer-loop failure
        story of SURVEY.md §5."""
        import time

        total = self.config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, int(self.state.round) + max_rounds)
        rounds_done = int(self.state.round)
        last_ckpt = rounds_done
        if rounds_done > 0 and bool(
            self.problem.is_best(jnp.asarray(self._best_score_jit(self.state)))
        ):
            # Resumed an already-solved checkpoint: don't burn a chunk
            # dispatch discovering that.
            total = rounds_done
        t0 = time.time()
        while not self.cancelled and rounds_done < total:
            n = min(chunk, total - rounds_done)
            self.state = self._chunk_jit(self.state, n)
            rounds_done += n
            score = jnp.asarray(self._best_score_jit(self.state))
            if verbose:
                # Best AND current, the reference's per-round progress line
                # (ref iterated_local_search.rs:176-179).
                cur = np.asarray(self.state.current_score)
                print(
                    f"[{self.problem.name}] round {rounds_done}/{total} "
                    f"best score: ({score[0]}, {score[1]}) "
                    f"current score: ({cur[0]}, {cur[1]})"
                )
            if checkpoint_path and rounds_done - last_ckpt >= checkpoint_every:
                self.save(checkpoint_path)
                last_ckpt = rounds_done
            if bool(self.problem.is_best(score)):
                break
        self._wall += time.time() - t0
        if checkpoint_path:
            self.save(checkpoint_path)

    # -- checkpoint / resume (SURVEY.md §5) -------------------------------

    def save(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import save_state

        save_state(
            path,
            self.state,
            {
                "problem": self.problem.name,
                "seed": self.config.seed,
                "population": 1,
            },
        )

    def load(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import load_state

        self.state, meta = load_state(path, self.state)
        # Real exceptions, not asserts: `python -O` strips asserts, and a
        # mismatched checkpoint would silently mis-trace (same pytree
        # structure, wrong meaning).
        if meta.get("problem") != self.problem.name:
            raise ValueError(
                f"checkpoint is for {meta.get('problem')}, "
                f"solver is {self.problem.name}"
            )
        # A population checkpoint has the same pytree structure (leading
        # [P] axis on every leaf) and would silently mis-trace here.
        if meta.get("population", 1) != 1:
            raise ValueError(
                f"checkpoint is population-mode (P={meta.get('population')}); "
                "resume it with the same --population"
            )

    # -- metrics ----------------------------------------------------------

    def stats(self) -> dict:
        iters = int(self.state.ls_iters_total)
        moves = iters * self.problem.width
        out = {
            "rounds": int(self.state.round),
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": int(self.state.tabu_exhausted_total),
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out

    def roofline(self, peaks, chunk: int = 2) -> dict:
        """FLOP/s and bandwidth of this solver's compiled chunk program as
        fractions of ``peaks`` (a ``utils.roofline.DevicePeaks``, e.g.
        ``peaks_for(jax.devices()[0].device_kind)``), scaled by the measured
        solve wall.  Costs come from XLA's own ``cost_analysis()`` of the
        optimized HLO.  Compiles one fresh program instance — call after a
        solve, not per round.  The reference has no perf accounting at all
        (SURVEY.md §5)."""
        from constraint_solver_tpu.utils.roofline import chunk_roofline

        return chunk_roofline(
            self._chunk_jit, self.state, int(self.state.round), self._wall,
            peaks, chunk,
        )
