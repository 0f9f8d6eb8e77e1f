"""Date-sharded SOLVER correctness: trajectory identity with the dense
solver (seq_shard as a solver, not only a scorer).

The sharded solve runs the unchanged ILS engine inside a shard_map over a
4-device ``seq`` mesh with the day axis sharded; every candidate score is
produced by the owner shard's halo-extended region + psum.  Scores are
small exact integers in f32, so the sharded trajectory must equal the
dense ``proposer="random"`` trajectory BIT-FOR-BIT on the same seed.
"""

import datetime

import jax
import numpy as np

from constraint_solver_tpu.core.ils import Solver, SolverConfig
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.parallel.seq_solver import SeqShardedSolver

D0 = datetime.date(2022, 5, 9)


def _spec(days, emps, holidays=None):
    return ScheduleSpec.from_dates(
        D0, D0 + datetime.timedelta(days=days - 1), emps, holidays
    )


def _cfg(rounds):
    return SolverConfig(
        seed="seqsolve",
        local_search_max_iterations=30,
        iterated_local_search_max_iterations=rounds,
        all_solutions_capacity=64,
        all_solution_iteration_expiry=200,
        best_solutions_capacity=8,
        max_allow_no_improvement_for=5,
    )


def test_seq_sharded_solve_equals_dense_trajectory():
    spec = _spec(64, 7, {0: [D0 + datetime.timedelta(days=5)],
                         3: [D0 + datetime.timedelta(days=k) for k in (10, 40)]})
    mesh = jax.make_mesh(
        (4,), ("seq",),
        axis_types=(jax.sharding.AxisType.Auto,),
    )

    sharded = SeqShardedSolver(spec, _cfg(12), mesh, window_size=32)
    sharded.run(max_rounds=12, chunk=4)
    (sh_hard, sh_soft), sh_assign = sharded.get_best_solution()

    dense = Solver(
        make_scheduling_problem(spec, window_size=32, proposer="random"),
        _cfg(12),
    )
    dense.run(max_rounds=12, chunk=4)
    (dn_hard, dn_soft), dn_assign = dense.get_best_solution()

    assert (sh_hard, sh_soft) == (dn_hard, dn_soft)
    np.testing.assert_array_equal(sh_assign, dn_assign)
    assert sharded.stats()["ls_iterations"] == dense.stats()["ls_iterations"]


def test_seq_sharded_solve_nondivisible_days():
    """D not divisible by the shard count: padded days must never leak into
    scores (sharded best score == dense full score of the same assign)."""
    spec = _spec(61, 5)
    mesh = jax.make_mesh(
        (4,), ("seq",),
        axis_types=(jax.sharding.AxisType.Auto,),
    )
    sharded = SeqShardedSolver(spec, _cfg(6), mesh, window_size=16)
    sharded.run(max_rounds=6, chunk=3)
    (hard, soft), assign = sharded.get_best_solution()
    assert assign.shape == (61,)
    dense_score = np.asarray(
        make_scheduling_problem(spec).score(jax.numpy.asarray(assign))
    )
    assert (hard, soft) == (dense_score[0], dense_score[1])


def _popseq_mesh():
    return jax.make_mesh(
        (2, 4), ("pop", "seq"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
    )


def test_popseq_solve_equals_dense_population_trajectory():
    """Mesh(pop, seq): a population of date-sharded trajectories with
    per-chunk elite exchange over pop must be BIT-IDENTICAL to the dense
    PopulationSolver on the same seed and exchange cadence (the runnable
    shape for BASELINE.json config[5])."""
    from constraint_solver_tpu.parallel.population import PopulationSolver

    spec = _spec(64, 7, {1: [D0 + datetime.timedelta(days=9)]})
    cfg = _cfg(8)

    sharded = SeqShardedSolver(
        spec, cfg, _popseq_mesh(), window_size=32,
        population=4, exchange_every=4, k_exchange=2,
    )
    sharded.run(max_rounds=8, chunk=4)
    (sh_hard, sh_soft), sh_assign = sharded.get_best_solution()

    dense = PopulationSolver(
        make_scheduling_problem(spec, window_size=32, proposer="random"),
        cfg, population=4, exchange_every=4, k_exchange=2,
    )
    dense.run(max_rounds=8, chunk=4)
    (dn_hard, dn_soft), dn_assign = dense.get_best_solution()

    assert (sh_hard, sh_soft) == (dn_hard, dn_soft)
    np.testing.assert_array_equal(sh_assign, dn_assign)
    assert sharded.stats()["ls_iterations"] == dense.stats()["ls_iterations"]


def test_popseq_exchange_on_vs_off():
    """Elite exchange over pop must actually couple the lanes: with it OFF
    the lanes are independent, so the two runs must diverge in state while
    the exchanged run's best is never worse."""
    spec = _spec(64, 7)
    cfg = _cfg(8)
    on = SeqShardedSolver(
        spec, cfg, _popseq_mesh(), window_size=32,
        population=4, exchange_every=4, k_exchange=2,
    )
    off = SeqShardedSolver(
        spec, cfg, _popseq_mesh(), window_size=32,
        population=4, exchange_every=4, k_exchange=0,
    )
    on.run(max_rounds=8, chunk=4)
    off.run(max_rounds=8, chunk=4)
    s_on = np.asarray(jax.device_get(on.state.elite.scores))
    s_off = np.asarray(jax.device_get(off.state.elite.scores))
    assert not np.array_equal(s_on, s_off)
    assert on.get_best_score() <= off.get_best_score()


def test_popseq_checkpoint_roundtrip(tmp_path):
    """save/load on the pop x seq solver: a resumed solve must be
    bit-identical to an uninterrupted one (driver parity)."""
    spec = _spec(64, 7)
    cfg = _cfg(8)
    mk = lambda: SeqShardedSolver(
        spec, cfg, _popseq_mesh(), window_size=32,
        population=4, exchange_every=4, k_exchange=2,
    )
    full = mk()
    full.run(max_rounds=8, chunk=4)

    part = mk()
    part.run(max_rounds=4, chunk=4)
    path = str(tmp_path / "popseq.npz")
    part.save(path)
    resumed = mk()
    resumed.load(path)
    assert not resumed.is_finished()
    assert resumed.get_iteration_info()["current"] == 4
    resumed.run(max_rounds=4, chunk=4)

    assert resumed.get_best_score() == full.get_best_score()
    np.testing.assert_array_equal(
        resumed.get_best_solution()[1], full.get_best_solution()[1]
    )
    def host_leaves(state):
        return [
            np.asarray(
                jax.random.key_data(leaf)
                if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key)
                else leaf
            )
            for leaf in jax.tree.leaves(state)
        ]

    for a, b in zip(host_leaves(resumed.state), host_leaves(full.state)):
        np.testing.assert_array_equal(a, b)
