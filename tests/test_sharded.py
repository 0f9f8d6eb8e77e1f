"""2D-sharded solving on the fake 8-device CPU mesh: population dp x
neighborhood tp with local-top-k + all_gather collectives."""

import jax
import numpy as np

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem
from constraint_solver_tpu.parallel.mesh import make_mesh
from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver


def _config():
    return SolverConfig(
        seed="42",
        local_search_max_iterations=150,
        best_solutions_capacity=8,
        all_solutions_capacity=64,
        all_solution_iteration_expiry=150,
        iterated_local_search_max_iterations=100,
        max_allow_no_improvement_for=5,
    )


def test_sharded_2d_mesh_solves():
    mesh = make_mesh(n_pop=4, n_nbr=2)
    problem = make_nqueens_problem(
        16, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16
    )
    solver = ShardedPopulationSolver(problem, _config(), population=8, mesh=mesh)
    solver.run(max_rounds=30, chunk=5)
    (hard, _), state = solver.get_best_solution()
    assert hard <= 2, f"sharded solver made no progress: {hard}"
    assert solver.stats()["ls_iterations"] > 0
    assert len(state.rows) == 16


def _lane_bests(solver):
    scores, _, _ = jax.vmap(lambda e: e.get_best())(solver.state.elite)
    return np.asarray(jax.device_get(scores))


def test_sharded_elite_exchange_on_vs_off():
    """With the per-chunk collective exchange, the global best is broadcast
    into EVERY lane's archive (all lane bests equal); without it, sharded
    lanes never communicate and their bests diverge/lag.  Same seed, same
    rounds — exchange must leave the population at least as converged on
    average, strictly better somewhere."""
    mesh = make_mesh(n_pop=4, n_nbr=2)
    problem = make_nqueens_problem(
        24, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16
    )

    # exchange_every=5 so the round-gated exchange fires at the first chunk
    # boundary even if the run converges (and breaks) right there.
    on = ShardedPopulationSolver(
        problem, _config(), population=8, mesh=mesh, k_exchange=4,
        exchange_every=5,
    )
    on.run(max_rounds=10, chunk=5)
    bests_on = _lane_bests(on)
    # Broadcast-insert: every lane's archive best == the global best.
    assert (bests_on == bests_on[0]).all(), bests_on

    off = ShardedPopulationSolver(
        problem, _config(), population=8, mesh=mesh, k_exchange=0
    )
    off.run(max_rounds=10, chunk=5)
    bests_off = _lane_bests(off)
    assert bests_on.mean() <= bests_off.mean()
    assert bests_on[:, 0].max() <= bests_off[:, 0].max()


def test_sharded_driver_api_parity(tmp_path):
    """The 2D-sharded solver must expose the
    full PopulationSolver driver surface — save/load, is_finished,
    get_iteration_info, per-tick execute_round, and moves/sec stats."""
    mesh = make_mesh(n_pop=4, n_nbr=2)
    problem = make_nqueens_problem(
        16, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16
    )
    a = ShardedPopulationSolver(problem, _config(), population=8, mesh=mesh)
    assert not a.is_finished()
    a.execute_round()
    info = a.get_iteration_info()
    assert info["current"] == 1 and info["total"] == 100
    a.run(max_rounds=9, chunk=3)
    stats = a.stats()
    assert stats["ls_iterations"] > 0
    assert stats["moves_evaluated"] == stats["ls_iterations"] * problem.width
    assert stats["moves_per_sec"] > 0

    path = str(tmp_path / "sharded.npz")
    a.save(path)
    b = ShardedPopulationSolver(problem, _config(), population=8, mesh=mesh)
    b.load(path)
    sa, _ = a.get_best_solution()
    sb, _ = b.get_best_solution()
    assert sa == sb
    # Deterministic continuation after resume.
    a.run(max_rounds=4, chunk=2)
    b.run(max_rounds=4, chunk=2)
    assert a.get_best_solution()[0] == b.get_best_solution()[0]


def test_sharded_cull_path():
    """Global rank-based culling across shards: the solver still runs and
    improves with cull_frac on (ranks computed from the all_gathered
    current scores)."""
    mesh = make_mesh(n_pop=4, n_nbr=2)
    problem = make_nqueens_problem(
        16, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16
    )
    solver = ShardedPopulationSolver(
        problem, _config(), population=8, mesh=mesh, cull_frac=0.25
    )
    solver.run(max_rounds=20, chunk=5)
    (hard, _), _ = solver.get_best_solution()
    assert hard <= 2


def test_sharded_candidate_list_consistent_with_unsharded_scoring():
    """Every candidate the sharded neighborhood emits must carry the score a
    full rescore assigns to its move (collectives must not scramble the
    (score, move) pairing)."""
    import jax.numpy as jnp

    from constraint_solver_tpu.models.nqueens import build_state, total_conflicts

    mesh = make_mesh(n_pop=1, n_nbr=4)
    jax.set_mesh(mesh)  # before creating arrays: they must live on this mesh
    problem = make_nqueens_problem(
        12, sample_cols=4, nbr_axis="nbr", nbr_shards=4, nbr_keep=8
    )
    rng = np.random.default_rng(2)
    rows = jnp.asarray(rng.integers(0, 12, size=12), jnp.int32)
    state = build_state(rows)
    cur = problem.score(state)

    def run(state):
        return problem.neighborhood(state, cur, jax.random.key(7))

    from jax.sharding import PartitionSpec as P

    jax.set_mesh(mesh)
    nb = jax.jit(
        jax.shard_map(
            run, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False
        )
    )(state)
    scores = np.asarray(nb.scores)
    cols_mv, rows_mv = np.asarray(nb.moves[0]), np.asarray(nb.moves[1])
    valid = np.asarray(nb.valid)
    assert valid.any()
    for i in np.flatnonzero(valid):
        applied = rows.at[int(cols_mv[i])].set(int(rows_mv[i]))
        assert scores[i, 0] == int(total_conflicts(applied))
