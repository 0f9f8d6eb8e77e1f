"""Vmapped trajectory populations with collective elite exchange.

The reference runs exactly one ILS trajectory (single ``rng``/``current`` at
reference iterated_local_search.rs:115-116).  The population layer
runs P independent trajectories as one vmapped program:

- per-trajectory PRNG streams via ``jax.random.split`` (SURVEY.md §2.5);
- per-trajectory tabu rings and elite archives (the reference's LS-private
  and ILS-level ``History`` instances, vectorized);
- periodic **elite exchange**: the global lexicographic top-k over all
  lanes' best solutions is broadcast-inserted into every lane's archive.
  Under a sharded population this compiles to an all-gather + top-k over
  the device interconnect — the equivalent of the reference's (nonexistent) cross-trajectory
  communication, cf. SURVEY.md §2.5 "Elite/best-solution exchange".

Sharding: ``PopulationSolver(..., mesh=...)`` lays the population axis over
the mesh's ``pop`` axis with ``NamedSharding``; XLA inserts the collectives.
"""

from __future__ import annotations

from functools import lru_cache, partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.ils import (
    IlsState,
    SolverConfig,
    ils_init,
    ils_round,
)
from constraint_solver_tpu.core.problem import Problem
from constraint_solver_tpu.ops.lex import lex_argmin, lex_top_k
from constraint_solver_tpu.parallel.mesh import pop_sharding, replicated
from constraint_solver_tpu.utils.seeding import seed_string_to_key


def portfolio_temps(population: int, mix: str = "reference") -> jax.Array:
    """Per-trajectory acceptance temperatures (the heterogeneous-portfolio
    analog of expert parallelism, SURVEY.md §2.5):

    - "reference": every lane runs the reference 1:5:1 acceptance (temp -1);
    - "mixed": half the lanes reference, a quarter greedy descent (temp 0),
      a quarter SA with temperatures log-spaced in [0.5, 8].
    """
    if mix == "reference":
        return jnp.full((population,), -1.0, jnp.float32)
    assert mix == "mixed", mix
    temps = np.full((population,), -1.0, np.float32)
    q = population // 4
    temps[:q] = 0.0
    if q > 0:
        temps[q : 2 * q] = np.logspace(
            np.log10(0.5), np.log10(8.0), num=q, dtype=np.float32
        )
    return jnp.asarray(temps)


def population_init(
    problem: Problem,
    config: SolverConfig,
    population: int,
    key: jax.Array,
    accept_temps: jax.Array | None = None,
) -> IlsState:
    """IlsState with a leading population axis on every leaf."""
    keys = jax.random.split(key, population)
    if accept_temps is None:
        accept_temps = portfolio_temps(population)
    return jax.vmap(
        lambda k, t: ils_init(problem, config, k, accept_temp=t)
    )(keys, accept_temps)


def exchange_elites(
    states: IlsState,
    k_exchange: int,
    cull_frac: float = 0.0,
    axis: str | None = None,
    cull_rank: str = "lex",
) -> IlsState:
    """Insert the global top-k elite solutions into every lane's archive;
    optionally CULL the worst ``cull_frac`` of lanes by resetting their
    current solution to their (post-exchange) archive best — the periodic
    portfolio culling of BASELINE.json's north star.

    With ``axis``, the call runs inside a ``shard_map`` over that mesh axis:
    lane bests are ``all_gather``ed over it (ICI on a pod) so the top-k and
    cull ranks are GLOBAL across every shard's lanes, while inserts/culls
    apply to the local lanes — the cross-device elite exchange of
    SURVEY.md §2.5."""
    scores, fps, bests = jax.vmap(lambda e: e.get_best())(states.elite)
    leaves, treedef = jax.tree.flatten(bests)
    if axis is not None:
        g = lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True)
        g_scores, g_fps, g_leaves = g(scores), g(fps), [g(l) for l in leaves]
    else:
        g_scores, g_fps, g_leaves = scores, fps, leaves
    top = lex_top_k(g_scores, k_exchange, g_fps, *g_leaves)
    top_scores, top_fps = top[0], top[1]
    top_states = jax.tree.unflatten(treedef, list(top[2:]))

    def insert_all(elite):
        def body(i, e):
            return e.insert(
                top_scores[i],
                top_fps[i],
                jax.tree.map(lambda a: a[i], top_states),
            )

        return jax.lax.fori_loop(0, k_exchange, body, elite)

    states = states._replace(elite=jax.vmap(insert_all)(states.elite))

    if cull_frac > 0.0:
        p_local = states.current_score.shape[0]
        cur = states.current_score  # [P, 2]
        if axis is not None:
            # Global ranks: every shard ranks the gathered scores
            # identically, then slices out its own lanes' ranks.
            g_cur = jax.lax.all_gather(cur, axis, axis=0, tiled=True)
        else:
            g_cur = cur
        p = g_cur.shape[0]
        if cull_rank == "lex":
            # Rank by (hard, soft) lexicographically.  Ranking by hard
            # alone degenerates once every lane reaches hard=0 (the soft
            # plateau the quality race lives on): all lanes tie and the
            # stable rank falls back to lane-index order, so the SAME
            # fixed cull_frac of lanes is recycled every exchange
            # regardless of soft score.  jnp.lexsort: last key is primary.
            order = jnp.lexsort((g_cur[:, 1], g_cur[:, 0]))
        else:
            assert cull_rank == "hard", cull_rank
            order = jnp.argsort(g_cur[:, 0], stable=True)
        ranks = jnp.argsort(order)
        if axis is not None:
            shard = jax.lax.axis_index(axis)
            rank = jax.lax.dynamic_slice(ranks, (shard * p_local,), (p_local,))
        else:
            rank = ranks
        n_cull = int(p * cull_frac)
        if n_cull > 0:
            # Worst lanes by current hard score restart from their archive
            # best (which now contains the global top-k).  Rank-based (double
            # argsort) so score TIES cull exactly n_cull lanes — a >=
            # threshold test would reset every tied lane and collapse the
            # portfolio onto identical elites.
            cull = rank >= p - n_cull
            b_score, b_fp, b_state = jax.vmap(lambda e: e.get_best())(
                states.elite
            )
            states = states._replace(
                current_state=jax.tree.map(
                    lambda a, b: jnp.where(
                        cull.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
                    ),
                    b_state,
                    states.current_state,
                ),
                current_score=jnp.where(cull[:, None], b_score, states.current_score),
                current_fp=jnp.where(cull[:, None], b_fp, states.current_fp),
            )
    return states


def _gated_exchange(st: IlsState, n: int, k_exchange: int, cull_frac: float,
                    exchange_every: int, axis: str | None = None,
                    cull_rank: str = "lex") -> IlsState:
    """End-of-chunk elite exchange, gated on the ROUND counter so the
    exchange cadence is a property of the solver configuration, not of how
    the host happens to chunk its dispatches: ``_chunk_jit(st, 1)`` stepped
    N times is trajectory-identical to ``_chunk_jit(st, N)`` (tested in
    tests/test_population.py).  An exchange at every chunk boundary would
    make per-round stepping (the serve layer, a fine-probe quality
    harness) exchange every round regardless of ``exchange_every``."""
    if k_exchange <= 0:
        return st
    ex = lambda s: exchange_elites(s, k_exchange, cull_frac, axis=axis,
                                   cull_rank=cull_rank)
    if exchange_every <= 1:
        return ex(st)
    # st.round has already advanced by n; lanes are lockstep (round[0] is
    # every lane's counter).
    return jax.lax.cond(
        (st.round[0] % exchange_every) == 0, ex, lambda s: s, st,
    )


@lru_cache(maxsize=64)
def _population_programs(
    problem: Problem, ls_params, ils_params, k_exchange: int,
    cull_frac: float, exchange_every: int, cull_rank: str, mesh,
):
    """Jitted population programs, shared across solver instances.

    Keyed by the (hashable) problem bundle + engine params + mesh: creating
    a second solver with the same ingredients must NOT re-trace/re-compile —
    without this cache, a fresh ``PopulationSolver`` pays the full compile
    on its first timed chunk, which can dwarf the solve itself."""
    round_fn = jax.vmap(partial(ils_round, problem, ls_params, ils_params))
    # Same body with the 1-based round number threaded as an UNBATCHED scalar:
    # lane round counters advance in lockstep (population_init starts every
    # lane at 0 and every call increments every lane), so the every-50-rounds
    # restart compiles to a real lax.cond instead of computing and discarding
    # a fresh O(n^2) problem.init on all P lanes every round.
    round_at = jax.vmap(
        partial(ils_round, problem, ls_params, ils_params), in_axes=(0, None)
    )

    def run_chunk(st: IlsState, n: int) -> IlsState:
        base = st.round[0]
        st = jax.lax.fori_loop(
            0, n, lambda i, s: round_at(s, base + 1 + i), st
        )
        # k_exchange=0 disables cross-lane exchange entirely (isolated
        # trajectories; also the exchange-cost ablation in
        # bench/sched_round_overhead.py — indexing the size-0 top-k would
        # fail at trace time otherwise).  Otherwise the exchange fires on
        # the exchange_every ROUND cadence, independent of chunking.
        return _gated_exchange(st, n, k_exchange, cull_frac, exchange_every,
                               cull_rank=cull_rank)

    def best_score_of(st: IlsState):
        scores, _, _ = jax.vmap(lambda e: e.get_best())(st.elite)
        return scores[lex_argmin(scores)]

    def run_chunk_traced(st: IlsState, n: int):
        """Like ``run_chunk`` but also returns a float32[n, 3] per-round
        trace of (round, best-hard, best-soft) read from the elite archives
        ON DEVICE after every round.  The host reads the trace once per
        chunk and timestamps the chunk boundary; per-round wall times are
        interpolated between boundaries — eliminating the probe-lag
        asymmetry of host-side best probes (quality-at-wall used to see
        only the best at the LAST chunk boundary before each budget).  The
        solver state
        trajectory is bit-identical to ``run_chunk`` (the trace reduction
        consumes no PRNG and writes nothing back; tested)."""
        base = st.round[0]

        def body(i, carry):
            s, tr = carry
            s = round_at(s, base + 1 + i)
            row = jnp.concatenate(
                [(base + 1 + i).astype(jnp.float32)[None], best_score_of(s)]
            )
            return s, jax.lax.dynamic_update_slice(tr, row[None, :], (i, 0))

        st, trace = jax.lax.fori_loop(
            0, n, body, (st, jnp.zeros((n, 3), jnp.float32))
        )
        st = _gated_exchange(st, n, k_exchange, cull_frac, exchange_every,
                             cull_rank=cull_rank)
        return st, trace

    # Host-read paths produce small REPLICATED outputs so they stay
    # addressable on every process under a multi-host global mesh.
    rep = replicated(mesh) if mesh is not None else None

    def jit_rep(f):
        return jax.jit(f, out_shardings=rep) if rep is not None else jax.jit(f)

    best_score = best_score_of

    def global_best(st: IlsState):
        scores, _, bests = jax.vmap(lambda e: e.get_best())(st.elite)
        lane = lex_argmin(scores)
        return scores[lane], jax.tree.map(lambda a: a[lane], bests)

    return SimpleNamespace(
        round=jax.jit(round_fn),
        chunk=jax.jit(run_chunk, static_argnums=1),
        chunk_traced=jax.jit(run_chunk_traced, static_argnums=1),
        best_score=jit_rep(best_score),
        global_best=jit_rep(global_best),
        # Cheap convergence probe: transfers 8 bytes, not the elite arrays.
        probe=jit_rep(lambda st: (st.round[0], jnp.sum(st.ls_iters_total))),
    )


@lru_cache(maxsize=64)
def _population_init_program(problem: Problem, caps: tuple, population: int, mesh):
    """``caps`` is the init-relevant subset of SolverConfig — (elite capacity,
    tabu capacity, tabu expiry).  Keying on the full config would miss the
    cache for solvers differing only by seed or round budget (the seed is a
    runtime key argument, not part of the traced program)."""
    config = SolverConfig(
        best_solutions_capacity=caps[0],
        all_solutions_capacity=caps[1],
        all_solution_iteration_expiry=caps[2],
    )

    def init(key, temps):
        return population_init(problem, config, population, key, temps)

    if mesh is None:
        return jax.jit(init)
    # Multi-host safe: build the global sharded state INSIDE jit
    # (device_put of process-local arrays onto a global sharding is
    # not allowed; jit with out_shardings is).
    return jax.jit(init, out_shardings=pop_sharding(mesh))


@jax.jit
def _reseed_jit(st: IlsState) -> IlsState:
    """Problem-independent elite reseed, jitted once at module level (a
    per-call closure would re-trace on every elastic-recovery event)."""

    def one(lane: IlsState) -> IlsState:
        key, k_pick = jax.random.split(lane.key)
        score, fp, state = lane.elite.get_random(k_pick)
        has = jnp.any(lane.elite.valid)
        sel = lambda a, b: jax.tree.map(
            lambda x, y: jnp.where(has, x, y), a, b
        )
        return lane._replace(
            current_state=sel(state, lane.current_state),
            current_score=jnp.where(has, score, lane.current_score),
            current_fp=jnp.where(has, fp, lane.current_fp),
            key=key,
        )

    return jax.vmap(one)(st)


class PopulationSolver:
    """Same driver API as ``core.ils.Solver`` over P parallel trajectories."""

    def __init__(
        self,
        problem: Problem,
        config: SolverConfig,
        population: int,
        exchange_every: int = 10,
        k_exchange: int = 4,
        mesh=None,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
    ):
        self.problem = problem
        self.config = config
        self.population = population
        self.exchange_every = exchange_every
        self.cancelled = False
        self._wall = 0.0
        self.mesh = mesh
        if mesh is not None:
            # sharding-in-types (jax>=0.7) wants the mesh as ambient context
            # for computations whose operands carry named shardings.
            jax.set_mesh(mesh)

        key = seed_string_to_key(config.seed)
        temps = portfolio_temps(population, portfolio)
        init_jit = _population_init_program(
            problem,
            (
                config.best_solutions_capacity,
                config.all_solutions_capacity,
                config.all_solution_iteration_expiry,
            ),
            population,
            mesh,
        )
        self.state = init_jit(key, temps)

        progs = _population_programs(
            problem, config.ls_params(problem.width), config.ils_params(),
            k_exchange, cull_frac, exchange_every, cull_rank, mesh,
        )
        self._round_jit = progs.round
        self._chunk_jit = progs.chunk
        self._chunk_traced_jit = progs.chunk_traced
        self._best_score_jit = progs.best_score
        self._global_best_jit = progs.global_best
        self._probe_jit = progs.probe

    # -- driver API (mirrors core.ils.Solver) ----------------------------

    def execute_round(self) -> None:
        # A 1-round chunk, NOT the bare vmapped round: the chunk program
        # carries the round-gated elite exchange, so per-tick stepping (the
        # serve layer's round endpoint) exchanges on the exchange_every
        # cadence exactly like run() — ADVICE.md round 4, finding 1.
        self.state = self._chunk_jit(self.state, 1)

    def execute_chunk_traced(self, n: int) -> np.ndarray:
        """Advance ``n`` rounds and return the on-device per-round best
        trace as a host float32[n, 3] array of (round, best-hard,
        best-soft) — the probe-free quality-at-wall instrument (reading
        the trace forces the chunk to complete, so the return doubles as
        the host sync point)."""
        if getattr(self, "_chunk_traced_jit", None) is None:
            raise NotImplementedError(
                "per-round best tracing is not wired for this solver's "
                "sharded chunk program; use get_best_score per chunk"
            )
        self.state, trace = self._chunk_traced_jit(self.state, n)
        return np.asarray(trace)

    def _round_count(self) -> int:
        return int(np.asarray(self._probe_jit(self.state)[0]))

    def is_finished(self) -> bool:
        return self._round_count() >= self.config.iterated_local_search_max_iterations

    def get_iteration_info(self) -> dict:
        return {
            "current": self._round_count(),
            "total": self.config.iterated_local_search_max_iterations,
        }

    def get_best_score(self) -> tuple:
        """(hard, soft) of the global best — transfers 8 bytes, not the
        solution tensors (quality-at-wall probes call this every chunk)."""
        score = np.asarray(self._best_score_jit(self.state))
        return (float(score[0]), float(score[1]))

    def get_best_solution(self):
        """Global best over all lanes' archives."""
        score, state = self._global_best_jit(self.state)
        score = np.asarray(score)
        state = jax.tree.map(np.asarray, state)
        return (float(score[0]), float(score[1])), state

    def cancel(self) -> None:
        self.cancelled = True

    def run(
        self,
        max_rounds: int | None = None,
        chunk: int | None = None,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 200,
    ) -> None:
        """Run rounds until finished/converged/cancelled.  With
        ``checkpoint_path``, the full population state (all lanes' solutions,
        archives, tabu rings, PRNG keys) snapshots every ``checkpoint_every``
        rounds and at exit — the restartable-outer-loop failure story of
        SURVEY.md §5 for the population mode."""
        import time

        chunk = chunk or self.exchange_every
        total = self.config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, self._round_count() + max_rounds)
        rounds_done = self._round_count()
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
                # Best AND current (lex-min over lanes), the reference's
                # per-round progress line (ref iterated_local_search.rs:176-179).
                cur = np.asarray(self.state.current_score)
                lane = np.lexsort((cur[:, 1], cur[:, 0]))[0]
                print(
                    f"[{self.problem.name} xP{self.population}] round "
                    f"{rounds_done}/{total} best score: ({score[0]}, {score[1]}) "
                    f"current score: ({cur[lane, 0]}, {cur[lane, 1]})"
                )
            if checkpoint_path and rounds_done - last_ckpt >= checkpoint_every:
                self.save(checkpoint_path)
                last_ckpt = rounds_done
            if bool(self.problem.is_best(score)):
                break
        self._wall += time.time() - t0
        if checkpoint_path:
            self.save(checkpoint_path)

    def stats(self) -> dict:
        rounds, iters = self._probe_jit(self.state)
        iters = int(np.asarray(iters))
        moves = iters * self.problem.width
        out = {
            "rounds": int(np.asarray(rounds)),
            "population": self.population,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": int(
                np.sum(np.asarray(jax.device_get(self.state.tabu_exhausted_total)))
            ),
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out

    def roofline(self, peaks, chunk: int = 2) -> dict:
        """Roofline accounting of the population chunk program (all lanes,
        including the elite exchange) against ``peaks``,
        scaled by the measured solve wall — see ``Solver.roofline``.  Also
        valid for ``ShardedPopulationSolver`` (its sharded chunk program is
        cost-analyzed as compiled, collectives included)."""
        from constraint_solver_tpu.utils.roofline import chunk_roofline

        return chunk_roofline(
            self._chunk_jit, self.state, self._round_count(), self._wall,
            peaks, chunk,
        )

    def reseed_from_elites(self) -> None:
        """Warm-restart every lane's current solution from a random entry of
        its elite archive — the elastic-recovery story (SURVEY.md §5): after
        a slice restart, load the last checkpoint (exact) or call this to
        re-converge from gathered elites (approximate but warm)."""
        self.state = _reseed_jit(self.state)

    # -- checkpoint / resume (SURVEY.md §5) -------------------------------

    def save(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import save_state

        save_state(
            path,
            self.state,
            {
                "problem": self.problem.name,
                "seed": self.config.seed,
                "population": self.population,
            },
        )

    def load(self, path: str) -> None:
        from constraint_solver_tpu.utils.checkpoint import load_state

        self.state, meta = load_state(path, self.state)
        # Real exceptions, not asserts (stripped under `python -O`): a
        # mismatched checkpoint would silently mis-trace otherwise.
        if meta.get("problem") != self.problem.name:
            raise ValueError(
                f"checkpoint is for {meta.get('problem')}, "
                f"solver is {self.problem.name}"
            )
        if meta.get("population", 1) != self.population:
            raise ValueError(
                f"checkpoint is for population={meta.get('population', 1)}, "
                f"solver has population={self.population}"
            )
        # The chunk programs derive every lane's restart schedule from
        # round[0] (lane-lockstep invariant: population_init zeroes all
        # lanes and every round advances all lanes).  A hand-merged state
        # with unequal rounds would silently restart lanes on wrong rounds.
        if np.unique(np.asarray(self.state.round)).size != 1:
            raise ValueError(
                "checkpoint violates the lane-lockstep round invariant "
                f"(rounds {np.unique(np.asarray(self.state.round))})"
            )
        if self.mesh is not None:
            # Subclasses with richer layouts (pop x seq) set _shardings;
            # device_put_global also handles multi-process meshes.
            from constraint_solver_tpu.parallel.mesh import device_put_global

            self.state = device_put_global(
                self.state, getattr(self, "_shardings", None)
                or pop_sharding(self.mesh)
            )
