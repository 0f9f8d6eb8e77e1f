"""2D-sharded solving: population data-parallel x neighborhood tensor-parallel.

The reference is single-threaded (SURVEY.md §2.5); this module is the scale-
out path this design replaces it with.  One SPMD program over a
``Mesh(pop, nbr)``:

- the trajectory population is sharded over ``pop`` (data parallel);
- within every trajectory, the candidate-neighborhood axis is sharded over
  ``nbr`` (the tensor-parallel analog): each device scores its slice of the
  sampled columns, takes a local top-k, and an ``all_gather`` over ``nbr``
  rebuilds a small global candidate list for the engine's
  pick-then-check selection;
- trajectory state is replicated across ``nbr`` and stays consistent because
  every shard runs the identical deterministic update;
- once per chunk, lanes exchange elites ACROSS the ``pop`` axis: lane bests
  are all_gathered, the global lexicographic top-k is broadcast-inserted
  into every lane's archive, and (optionally) the globally-worst lanes are
  culled to their archive best — the same semantics as the 1D
  ``PopulationSolver`` (parallel/population.py exchange_elites), realized
  with explicit collectives inside the shard_map.

Built as ``shard_map(vmap(ils_round))`` — the engine and problem code are
unchanged except for the neighborhood's collective, which the problem
factory takes as ``nbr_axis``.  The driver API (run / is_finished /
get_iteration_info / get_best_solution / stats / save / load /
reseed_from_elites) is inherited from ``PopulationSolver``.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
from jax.sharding import PartitionSpec as P

from constraint_solver_tpu.core.ils import IlsState, SolverConfig, ils_round
from constraint_solver_tpu.core.problem import Problem
from constraint_solver_tpu.parallel.population import (
    PopulationSolver,
    _gated_exchange,
)


@lru_cache(maxsize=64)
def _sharded_chunk_program(
    problem: Problem, ls_params, ils_params, k_exchange: int,
    cull_frac: float, exchange_every: int, cull_rank: str, mesh,
):
    """Jitted sharded-chunk program, shared across solver instances (same
    no-recompile contract as parallel/population.py's program caches):
    ``n`` vmapped ILS rounds per shard, then one collective elite exchange
    over the ``pop`` axis."""
    # Round number threaded as an unbatched scalar so the periodic restart
    # is a real branch (see ils_round round_scalar); lane round counters are
    # lockstep-equal across shards too (every lane increments every call).
    round_at = jax.vmap(
        partial(ils_round, problem, ls_params, ils_params), in_axes=(0, None)
    )

    def shard_body(st: IlsState, n: int) -> IlsState:
        base = st.round[0]
        st = jax.lax.fori_loop(
            0, n, lambda i, s: round_at(s, base + 1 + i), st
        )
        # Round-gated exchange (see population._gated_exchange): the
        # cond predicate is the lockstep round counter, equal on every
        # shard, so the collective-bearing branch executes uniformly.
        return _gated_exchange(
            st, n, k_exchange, cull_frac, exchange_every, axis="pop",
            cull_rank=cull_rank,
        )

    def run_chunk(st: IlsState, n: int) -> IlsState:
        return jax.shard_map(
            partial(shard_body, n=n),
            mesh=mesh,
            in_specs=P("pop"),
            out_specs=P("pop"),
            check_vma=False,
        )(st)

    return jax.jit(run_chunk, static_argnums=1)


class ShardedPopulationSolver(PopulationSolver):
    """``PopulationSolver`` over a 2D mesh: lanes split over ``pop``, each
    lane's neighborhood split over ``nbr``.  ``problem`` must have been
    built with ``nbr_axis="nbr"`` so its neighborhood performs the
    local-top-k + all_gather collective.  ``k_exchange=0`` disables the
    per-chunk elite exchange (used by A/B convergence tests)."""

    def __init__(
        self,
        problem: Problem,
        config: SolverConfig,
        population: int,
        mesh,
        exchange_every: int = 10,
        k_exchange: int = 4,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
    ):
        n_pop = mesh.shape["pop"]
        if population % n_pop != 0:
            raise ValueError(
                f"population {population} must divide over the pop axis "
                f"({n_pop} shards)"
            )
        super().__init__(
            problem,
            config,
            population,
            exchange_every=exchange_every,
            k_exchange=k_exchange,
            mesh=mesh,
            portfolio=portfolio,
            cull_frac=cull_frac,
            cull_rank=cull_rank,
        )
        # Replace the 1D chunk program with the explicit-collective one;
        # every other jitted program (probe, best_score, global_best, init)
        # is sharding-agnostic and inherited as-is.  The inherited 1D
        # traced-chunk program cannot bind the ``nbr`` collective; disable
        # it rather than let it mis-trace.
        self._chunk_jit = _sharded_chunk_program(
            problem, config.ls_params(problem.width), config.ils_params(),
            k_exchange, cull_frac, exchange_every, cull_rank, mesh,
        )
        self._chunk_traced_jit = None

    def execute_round(self) -> None:
        # The inherited single-round program can't bind the ``nbr``
        # collective outside shard_map; a 1-round chunk is the per-tick
        # step (the chunk program's exchange is round-gated, so stepping
        # keeps the exchange_every cadence exactly like run()).
        self.state = self._chunk_jit(self.state, 1)
