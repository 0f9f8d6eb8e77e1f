"""Population layer tests on the virtual 8-device CPU mesh (SURVEY.md §4:
fake-multi-device tests stand in for a multi-device backend)."""

import jax
import numpy as np

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem
from constraint_solver_tpu.parallel.mesh import make_mesh, pop_sharding
from constraint_solver_tpu.parallel.population import (
    PopulationSolver,
    exchange_elites,
    population_init,
)


def _config(rounds=40):
    return SolverConfig(
        seed="42",
        local_search_max_iterations=200,
        best_solutions_capacity=8,
        all_solutions_capacity=64,
        all_solution_iteration_expiry=200,
        iterated_local_search_max_iterations=rounds,
        max_allow_no_improvement_for=5,
    )


def test_population_solves_8queens():
    solver = PopulationSolver(make_nqueens_problem(8), _config(), population=8)
    solver.run()
    (hard, _), best_state = solver.get_best_solution()
    assert hard == 0
    assert sorted(best_state.rows.tolist()) == list(range(8))


def test_population_sharded_over_mesh():
    mesh = make_mesh(n_pop=8, n_nbr=1)
    solver = PopulationSolver(
        make_nqueens_problem(8), _config(), population=16, mesh=mesh
    )
    # State really is sharded over the 'pop' axis.
    shard_devs = {
        d.id for d in solver.state.current_state.rows.sharding.device_set
    }
    assert len(shard_devs) == 8
    solver.run(max_rounds=20)
    (hard, _), _ = solver.get_best_solution()
    assert hard <= 4  # made real progress; usually 0


def test_population_4096_trajectories_sharded():
    """BASELINE config[3]: a 4096-trajectory restart portfolio with global
    best reduction, sharded over the (virtual) 8-device mesh.  Tiny budgets
    keep it fast — the point is that the 4096-lane program compiles, shards,
    and reduces correctly."""
    mesh = make_mesh(n_pop=8, n_nbr=1)
    config = SolverConfig(
        seed="42",
        local_search_max_iterations=10,
        best_solutions_capacity=4,
        all_solutions_capacity=16,
        all_solution_iteration_expiry=16,
        iterated_local_search_max_iterations=2,
        max_allow_no_improvement_for=2,
    )
    solver = PopulationSolver(
        make_nqueens_problem(8), config, population=4096, mesh=mesh,
        portfolio="mixed",
    )
    shard_devs = {
        d.id for d in solver.state.current_state.rows.sharding.device_set
    }
    assert len(shard_devs) == 8
    solver.run(max_rounds=2, chunk=2)
    (hard, _), best_state = solver.get_best_solution()
    # 4096 random-restart lanes on 8-queens: the global best is essentially
    # always a solution after one descent; assert a strong bound regardless.
    assert hard <= 2
    assert sorted(best_state.rows.tolist()) == list(range(8))


def test_exchange_elites_broadcasts_global_best():
    problem = make_nqueens_problem(8)
    config = _config()
    states = population_init(problem, config, 8, jax.random.key(0))
    # Run a few rounds so archives are populated and diverse.
    from constraint_solver_tpu.core.ils import ils_round
    from functools import partial

    round_fn = jax.vmap(
        partial(ils_round, problem, config.ls_params(), config.ils_params())
    )
    for _ in range(3):
        states = round_fn(states)
    scores_before, _, _ = jax.vmap(lambda e: e.get_best())(states.elite)
    global_best = np.asarray(scores_before)[:, 0].min()

    states = exchange_elites(states, k_exchange=4)
    scores_after, _, _ = jax.vmap(lambda e: e.get_best())(states.elite)
    # Every lane's archive now holds the global best.
    assert np.all(np.asarray(scores_after)[:, 0] == global_best)


def test_population_deterministic():
    results = []
    for _ in range(2):
        solver = PopulationSolver(
            make_nqueens_problem(8), _config(rounds=10), population=4
        )
        solver.run()
        (hard, soft), state = solver.get_best_solution()
        results.append((hard, soft, tuple(state.rows.tolist())))
    assert results[0] == results[1]


def test_reseed_from_elites():
    solver = PopulationSolver(make_nqueens_problem(8), _config(rounds=20), population=4)
    solver.run(max_rounds=10)
    import numpy as np

    scores_best, _, _ = jax.vmap(lambda e: e.get_best())(solver.state.elite)
    solver.reseed_from_elites()
    cur = np.asarray(solver.state.current_fp)
    elite_fps = np.asarray(solver.state.elite.fps)
    valid = np.asarray(solver.state.elite.valid)
    # Every lane's current fingerprint now matches one of its elites.
    for lane in range(4):
        lane_fps = {tuple(f) for f, v in zip(elite_fps[lane], valid[lane]) if v}
        assert tuple(cur[lane]) in lane_fps


def _tree_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x, y = jax.random.key_data(x), jax.random.key_data(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_chunk_size_independent_trajectories():
    """The elite exchange is gated on the ROUND counter (ADVICE r4): as
    long as the host chunk size divides exchange_every, the trajectory is
    identical however the dispatches are sliced — 8x1 == 2x4 == 4+4 with
    exchange_every=4.  Per-tick stepping (execute_round) therefore runs the
    production cadence, which is what the serve layer advertises."""
    problem = make_nqueens_problem(12)
    cfg = _config(rounds=100)

    def make():
        return PopulationSolver(
            problem, cfg, population=8, exchange_every=4, cull_frac=0.25
        )

    by_ones = make()
    for _ in range(8):
        by_ones.execute_round()
    by_fours = make()
    by_fours.state = by_fours._chunk_jit(by_fours.state, 4)
    by_fours.state = by_fours._chunk_jit(by_fours.state, 4)
    by_twos = make()
    for _ in range(4):
        by_twos.state = by_twos._chunk_jit(by_twos.state, 2)
    _tree_equal(by_ones.state, by_fours.state)
    _tree_equal(by_twos.state, by_fours.state)


def test_chunk_traced_matches_chunk_and_is_monotone():
    """The traced chunk program must leave the
    solver state bit-identical to the untraced program, and its per-round
    (round, best-hard, best-soft) rows must be the monotone elite-best
    series ending at the post-chunk global best."""
    problem = make_nqueens_problem(10)
    cfg = _config(rounds=100)
    a = PopulationSolver(problem, cfg, population=8, exchange_every=2)
    b = PopulationSolver(problem, cfg, population=8, exchange_every=2)
    trace = b.execute_chunk_traced(6)
    a.state = a._chunk_jit(a.state, 6)
    _tree_equal(a.state, b.state)
    assert trace.shape == (6, 3)
    np.testing.assert_array_equal(trace[:, 0], np.arange(1, 7))
    pairs = [tuple(r) for r in trace[:, 1:]]
    assert all(pairs[i] >= pairs[i + 1] for i in range(len(pairs) - 1)), pairs
    # Exchange/cull never changes the global archive best, so the last
    # trace row == the post-chunk best.
    assert tuple(trace[-1, 1:]) == b.get_best_score()
    # A second traced chunk continues the round numbering.
    trace2 = b.execute_chunk_traced(3)
    np.testing.assert_array_equal(trace2[:, 0], np.arange(7, 10))
    assert tuple(trace2[0, 1:]) <= tuple(trace[-1, 1:])


def test_cull_rank_lex_vs_hard_on_soft_plateau():
    """On a hard-score plateau (every lane at
    hard=0, the state the quality race lives in), lexicographic cull rank
    recycles the worst-SOFT lanes; hard-only rank degenerates to
    lane-index order and recycles a fixed set regardless of soft."""
    import jax.numpy as jnp

    problem = make_nqueens_problem(8)
    base = population_init(problem, _config(), 8, jax.random.key(3))
    # Fill archives so every lane has a (real) best to restart from.
    from functools import partial

    from constraint_solver_tpu.core.ils import ils_round

    cfg = _config()
    rfn = jax.jit(jax.vmap(partial(
        ils_round, problem, cfg.ls_params(problem.width), cfg.ils_params()
    )))
    for _ in range(3):
        base = rfn(base)
    # Craft a soft plateau: hard=0 everywhere, soft DESCENDING by lane
    # (lane 0 is worst).  Values >= 100 cannot collide with real nqueens
    # archive scores (soft channel is always 0 there).
    crafted = jnp.stack(
        [jnp.zeros(8), 107.0 - jnp.arange(8, dtype=jnp.float32)], axis=-1
    )
    plateau = base._replace(current_score=crafted)

    culled_lanes = {}
    for rank in ("lex", "hard"):
        out = exchange_elites(plateau, 2, cull_frac=0.25, cull_rank=rank)
        after = np.asarray(out.current_score)
        culled_lanes[rank] = {
            i for i in range(8)
            if not np.array_equal(after[i], np.asarray(crafted)[i])
        }
    # lex: the two largest soft values (lanes 0, 1) are recycled.
    assert culled_lanes["lex"] == {0, 1}, culled_lanes
    # hard: all-tied hard -> stable index order -> the LAST two lanes,
    # regardless of their (better) soft scores.
    assert culled_lanes["hard"] == {6, 7}, culled_lanes
