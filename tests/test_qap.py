"""QAP domain tests: all-pairs swap deltas vs naive rescoring, engine
integration, brute-force optimality on a tiny instance."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from constraint_solver_tpu.core.ils import Solver, SolverConfig
from constraint_solver_tpu.models.qap import (
    QAPSpec,
    exactness_precision,
    make_qap_problem,
    qap_cost_int32,
    qap_cost_naive,
)


def test_score_matches_naive():
    spec = QAPSpec.random(12, seed=1)
    flow, dist = spec.arrays()
    problem = make_qap_problem(spec)
    rng = np.random.default_rng(2)
    for _ in range(5):
        p = rng.permutation(12)
        got = float(np.asarray(problem.score(jnp.asarray(p, jnp.int32)))[0])
        assert got == qap_cost_naive(flow, dist, p)


def test_all_pairs_swap_deltas_match_full_rescore():
    spec = QAPSpec.random(10, seed=3)
    flow, dist = spec.arrays()
    problem = make_qap_problem(spec)
    rng = np.random.default_rng(4)
    p = rng.permutation(10)
    pj = jnp.asarray(p, jnp.int32)
    nb = problem.neighborhood(pj, problem.score(pj), jax.random.key(0))
    scores = np.asarray(nb.scores)[:, 0]
    a_idx, b_idx = np.asarray(nb.moves[0]), np.asarray(nb.moves[1])
    valid = np.asarray(nb.valid)
    assert valid.sum() == 10 * 9 // 2
    for i in np.flatnonzero(valid):
        q = p.copy()
        q[a_idx[i]], q[b_idx[i]] = q[b_idx[i]], q[a_idx[i]]
        assert scores[i] == qap_cost_naive(flow, dist, q), (
            f"swap ({a_idx[i]}, {b_idx[i]})"
        )


def test_move_fp_and_apply():
    spec = QAPSpec.random(8, seed=5)
    problem = make_qap_problem(spec)
    p = jnp.asarray(np.random.default_rng(6).permutation(8), jnp.int32)
    nb = problem.neighborhood(p, problem.score(p), jax.random.key(0))
    fp0 = problem.fingerprint(p)
    for i in np.flatnonzero(np.asarray(nb.valid))[::7]:
        applied = problem.apply_move(p, nb.moves, int(i))
        assert sorted(np.asarray(applied).tolist()) == list(range(8))
        np.testing.assert_array_equal(
            np.asarray(problem.fingerprint(applied)),
            np.asarray(problem.move_fp(p, fp0, nb.moves, int(i))),
        )


def test_perturb_preserves_permutation():
    spec = QAPSpec.random(16, seed=7)
    problem = make_qap_problem(spec)
    p = jnp.asarray(np.random.default_rng(8).permutation(16), jnp.int32)
    for s in range(8):
        q = problem.perturb(p, jnp.asarray(s % 2 == 0), jax.random.key(s))
        assert sorted(np.asarray(q).tolist()) == list(range(16))


def test_ils_finds_brute_force_optimum_n7():
    spec = QAPSpec.random(7, seed=9)
    flow, dist = spec.arrays()
    best = min(
        qap_cost_naive(flow, dist, np.asarray(perm))
        for perm in itertools.permutations(range(7))
    )
    problem = make_qap_problem(spec)
    solver = Solver(
        problem,
        SolverConfig(
            seed="q",
            local_search_max_iterations=200,
            best_solutions_capacity=8,
            all_solutions_capacity=64,
            all_solution_iteration_expiry=200,
            iterated_local_search_max_iterations=60,
            max_allow_no_improvement_for=5,
        ),
    )
    solver.run(chunk=20)
    (cost, _), p = solver.get_best_solution()
    assert cost == best, f"ILS found {cost}, brute force optimum {best}"
    assert sorted(p.tolist()) == list(range(7))


def test_cli_smoke(capsys):
    from constraint_solver_tpu.cli import qap as cli

    rc = cli.main(["--platform", "cpu", "--size", "12", "--rounds", "10",
                   "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0 and "result.cost" in out


def test_qap_sharded_neighborhood_consistent():
    """nbr-sharded QAP: every candidate the collective neighborhood emits
    carries exactly the score a full rescore assigns to its swap (the
    local-top-k + all_gather must not scramble the (score, move) pairing),
    and the globally best swap survives the per-shard top-k."""
    import jax
    from jax.sharding import PartitionSpec as P

    from constraint_solver_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_pop=1, n_nbr=4)
    jax.set_mesh(mesh)
    spec = QAPSpec.random(16, seed=3)
    problem = make_qap_problem(spec, nbr_axis="nbr", nbr_shards=4, nbr_keep=8)
    flow, dist = spec.arrays()
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.permutation(16), jnp.int32)
    cur = problem.score(p)

    nb = jax.jit(
        jax.shard_map(
            lambda q: problem.neighborhood(q, cur, jax.random.key(0)),
            mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False,
        )
    )(p)
    scores = np.asarray(nb.scores)
    a_idx, b_idx = np.asarray(nb.moves[0]), np.asarray(nb.moves[1])
    valid = np.asarray(nb.valid)
    assert valid.any()
    best_emitted = np.inf
    for i in np.flatnonzero(valid):
        q = np.asarray(p).copy()
        q[a_idx[i]], q[b_idx[i]] = q[b_idx[i]], q[a_idx[i]]
        assert scores[i, 0] == qap_cost_naive(flow, dist, q)
        best_emitted = min(best_emitted, scores[i, 0])
    # The global best swap is in the emitted list.
    full = make_qap_problem(spec)
    nb_full = full.neighborhood(p, cur, jax.random.key(0))
    full_best = float(
        np.min(np.where(np.asarray(nb_full.valid),
                        np.asarray(nb_full.scores)[:, 0], np.inf))
    )
    assert best_emitted == full_best


def test_qap_sharded_population_solves():
    """QAP on the 2D (pop x nbr) mesh end-to-end via the sharded solver."""
    import jax

    from constraint_solver_tpu.core.ils import SolverConfig
    from constraint_solver_tpu.parallel.mesh import make_mesh
    from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver

    mesh = make_mesh(n_pop=2, n_nbr=4)
    spec = QAPSpec.random(16, seed=1)
    problem = make_qap_problem(spec, nbr_axis="nbr", nbr_shards=4, nbr_keep=16)
    config = SolverConfig(
        seed="qap2d",
        local_search_max_iterations=60,
        iterated_local_search_max_iterations=40,
        all_solutions_capacity=64,
        all_solution_iteration_expiry=200,
        max_allow_no_improvement_for=5,
    )
    solver = ShardedPopulationSolver(problem, config, population=4, mesh=mesh)
    solver.run(max_rounds=20, chunk=4)
    (hard, _), perm = solver.get_best_solution()
    flow, dist = spec.arrays()
    assert hard == qap_cost_naive(flow, dist, np.asarray(perm))
    assert sorted(np.asarray(perm).tolist()) == list(range(16))


def test_compact_neighborhood_scores_and_winner_match_dense():
    """compact=True (row-min compaction, models/qap.py): every emitted
    candidate carries exactly the full-rescore score of its swap, and the
    lexicographic winner is IDENTICAL to the dense path's (same (a, b)
    move, same score) — the tie-break proof in the docstring, tested."""
    from constraint_solver_tpu.ops.lex import lex_argmin

    for seed in range(4):
        spec = QAPSpec.random(12, seed=seed, max_val=5)
        flow, dist = spec.arrays()
        dense = make_qap_problem(spec)
        comp = make_qap_problem(spec, compact=True)
        p = dense.init(jax.random.key(seed))
        cur = dense.score(p)
        nb_d = dense.neighborhood(p, cur, jax.random.key(0))
        nb_c = comp.neighborhood(p, cur, jax.random.key(0))
        # n-wide candidate list, one per facility row, row n-1 invalid.
        assert nb_c.valid.shape == (12,)
        assert int(nb_c.n_valid) == int(np.sum(np.asarray(nb_c.valid))) == 11
        a_idx, b_idx = np.asarray(nb_c.moves[0]), np.asarray(nb_c.moves[1])
        scores = np.asarray(nb_c.scores)[:, 0]
        pn = np.asarray(p)
        for i in np.flatnonzero(np.asarray(nb_c.valid)):
            q = pn.copy()
            q[a_idx[i]], q[b_idx[i]] = q[b_idx[i]], q[a_idx[i]]
            assert scores[i] == qap_cost_naive(flow, dist, q)
        # Winner identity: same move, same score as the dense argmin.
        wd = int(lex_argmin(nb_d.scores, nb_d.valid))
        wc = int(lex_argmin(nb_c.scores, nb_c.valid))
        assert (a_idx[wc], b_idx[wc]) == (
            int(nb_d.moves[0][wd]), int(nb_d.moves[1][wd]))
        assert scores[wc] == float(np.asarray(nb_d.scores)[wd, 0])


def test_compact_ils_finds_brute_force_optimum_n7():
    """The compact problem drives the full ILS stack to the same brute-force
    optimum the dense path reaches (test above)."""
    spec = QAPSpec.random(7, seed=9)
    flow, dist = spec.arrays()
    best = min(
        qap_cost_naive(flow, dist, np.asarray(perm))
        for perm in itertools.permutations(range(7))
    )
    problem = make_qap_problem(spec, compact=True)
    solver = Solver(
        problem,
        SolverConfig(
            seed="q",
            local_search_max_iterations=200,
            best_solutions_capacity=8,
            all_solutions_capacity=64,
            all_solution_iteration_expiry=200,
            iterated_local_search_max_iterations=60,
            max_allow_no_improvement_for=5,
        ),
    )
    solver.run(chunk=20)
    (cost, _), p = solver.get_best_solution()
    assert cost == best, f"compact ILS found {cost}, optimum {best}"
    assert sorted(p.tolist()) == list(range(7))


def test_incremental_state_tracks_exactly_through_descent():
    """incremental=True (models/qap.py QAPState): walking a greedy descent,
    the carried G stays EXACTLY D[p][:, p] and H exactly F G (small-integer
    f32 arithmetic), the per-step winner matches the compact path's, and
    every accepted score matches the host oracle."""
    from constraint_solver_tpu.ops.lex import lex_argmin

    for seed in range(2):
        spec = QAPSpec.random(14, seed=seed, max_val=7)
        flow, dist = spec.arrays()
        comp = make_qap_problem(spec, compact=True)
        inc = make_qap_problem(spec, incremental=True)
        key = jax.random.key(seed)
        st = inc.init(key)
        p = st.p  # same permutation for the compact walk
        cur = inc.score(st)
        assert float(np.asarray(cur)[0]) == qap_cost_naive(
            flow, dist, np.asarray(st.p))
        for step in range(12):
            nb_i = inc.neighborhood(st, cur, jax.random.key(step))
            nb_c = comp.neighborhood(p, cur, jax.random.key(step))
            wi = int(lex_argmin(nb_i.scores, nb_i.valid))
            wc = int(lex_argmin(nb_c.scores, nb_c.valid))
            np.testing.assert_array_equal(
                np.asarray(nb_i.scores), np.asarray(nb_c.scores))
            assert (int(nb_i.moves[0][wi]), int(nb_i.moves[1][wi])) == (
                int(nb_c.moves[0][wc]), int(nb_c.moves[1][wc]))
            # fingerprints agree between the two representations
            np.testing.assert_array_equal(
                np.asarray(inc.move_fp(st, inc.fingerprint(st), nb_i.moves, wi)),
                np.asarray(comp.move_fp(p, comp.fingerprint(p), nb_c.moves, wc)),
            )
            st = inc.apply_move(st, nb_i.moves, wi)
            p = comp.apply_move(p, nb_c.moves, wc)
            cur = nb_i.scores[wi]
            np.testing.assert_array_equal(np.asarray(st.p), np.asarray(p))
            # G exact, H exact (integers below 2^24 at this size)
            pn = np.asarray(st.p)
            g_want = dist[np.ix_(pn, pn)]
            np.testing.assert_array_equal(np.asarray(st.g), g_want)
            np.testing.assert_array_equal(
                np.asarray(st.h), flow @ g_want.astype(np.float32))
            assert float(np.asarray(cur)[0]) == qap_cost_naive(flow, dist, pn)
        # Perturbation rebuilds G/H for the new permutation exactly.
        st2 = inc.perturb(st, jnp.asarray(False), jax.random.key(99))
        pn2 = np.asarray(st2.p)
        assert sorted(pn2.tolist()) == list(range(14))
        np.testing.assert_array_equal(np.asarray(st2.g), dist[np.ix_(pn2, pn2)])


def test_incremental_ils_finds_brute_force_optimum_n7():
    """The incremental problem drives the full ILS stack (elite archive of
    QAPStates, restarts, perturbations) to the brute-force optimum."""
    spec = QAPSpec.random(7, seed=9)
    flow, dist = spec.arrays()
    best = min(
        qap_cost_naive(flow, dist, np.asarray(perm))
        for perm in itertools.permutations(range(7))
    )
    problem = make_qap_problem(spec, incremental=True)
    solver = Solver(
        problem,
        SolverConfig(
            seed="q",
            local_search_max_iterations=200,
            best_solutions_capacity=8,
            all_solutions_capacity=64,
            all_solution_iteration_expiry=200,
            iterated_local_search_max_iterations=60,
            max_allow_no_improvement_for=5,
        ),
    )
    solver.run(chunk=20)
    (cost, _), st = solver.get_best_solution()
    assert cost == best, f"incremental ILS found {cost}, optimum {best}"
    assert sorted(np.asarray(st.p).tolist()) == list(range(7))


def test_neighborhood_n_valid_matches_mask():
    """Neighborhood.n_valid contract (core/problem.py): the algebraic
    candidate count must equal the mask's population count.  (A
    proposer-computed hint_idx was tried and reverted: its per-lane
    dynamic row slice lowered to a serialized gather.)"""
    import jax

    for seed in range(3):
        spec = QAPSpec.random(12, seed=seed, max_val=3)
        problem = make_qap_problem(spec)
        key = jax.random.key(seed)
        p = problem.init(key)
        nb = problem.neighborhood(p, problem.score(p), key)
        assert nb.hint_idx is None
        assert int(nb.n_valid) == int(np.sum(np.asarray(nb.valid)))


def _walk_incremental_descent(spec, steps):
    """Greedy descent on the incremental problem: after every applied swap
    the carried G, H and cost must equal a float64 host rebuild exactly, and
    every accepted score must be the float32 rounding of the exact cost."""
    from constraint_solver_tpu.ops.lex import lex_argmin

    flow, dist = spec.arrays()
    flow64 = flow.astype(np.float64)
    inc = make_qap_problem(spec, incremental=True)
    st = inc.init(jax.random.key(0))
    cur = inc.score(st)
    for step in range(steps):
        nb = inc.neighborhood(st, cur, jax.random.key(step))
        w = int(lex_argmin(nb.scores, nb.valid))
        st = inc.apply_move(st, nb.moves, w)
        cur = nb.scores[w]
        pn = np.asarray(st.p)
        g_want = dist[np.ix_(pn, pn)].astype(np.float64)
        np.testing.assert_array_equal(np.asarray(st.g), g_want)
        np.testing.assert_array_equal(np.asarray(st.h), flow64 @ g_want)
        exact = qap_cost_naive(flow, dist, pn)
        assert int(st.cost) == exact
        assert float(np.asarray(cur)[0]) == np.float32(exact)


def test_scores_exact_above_float32_integer_range():
    """Costs beyond 2^24 (not every integer is a float32): the compact and
    incremental scores are the float32 rounding of the exact integer cost,
    never a float sum's rounding error or drift."""
    spec = QAPSpec.random(200, seed=3, max_val=100)
    flow, dist = spec.arrays()
    comp = make_qap_problem(spec, compact=True)
    p = comp.init(jax.random.key(1))
    exact = qap_cost_naive(flow, dist, np.asarray(p))
    assert exact > 2**24
    assert float(np.asarray(comp.score(p))[0]) == np.float32(exact)
    _walk_incremental_descent(spec, steps=8)


def test_non_integer_instance_rejected():
    spec = QAPSpec(flow=((0.0, 0.5), (0.5, 0.0)), dist=((0.0, 1.0), (1.0, 0.0)))
    with pytest.raises(ValueError, match="integer"):
        make_qap_problem(spec)


def _pair_spec(x, y):
    return QAPSpec(flow=((0, x), (x, 0)), dist=((0, y), (y, 0)))


@pytest.mark.parametrize("y,ok", [(1295, True), (1296, False)])
def test_float32_delta_bound(y, ok):
    """The largest float32 intermediate, 10 * 1295 * y here, must stay
    within 2^24: y = 1295 is just inside, y = 1296 just past."""
    spec = _pair_spec(1295, y)
    if ok:
        p = make_qap_problem(spec, incremental=True)
        assert int(p.init(jax.random.key(0)).cost) == 2 * 1295 * y
    else:
        with pytest.raises(ValueError, match="float32"):
            make_qap_problem(spec)


@pytest.mark.parametrize("v,ok", [(511, True), (512, False)])
def test_int32_cost_bound(v, ok):
    """n = 2049, flows v and distances 1 off the diagonal: the cost bound
    2049 * 2048 * v passes 2^31 at v = 512 (float bounds hold for both)."""
    n = 2049
    off = 1 - np.eye(n, dtype=np.float32)
    if ok:
        assert exactness_precision(v * off, off) is None
    else:
        with pytest.raises(ValueError, match="int32"):
            exactness_precision(v * off, off)


@pytest.mark.parametrize("x,want", [
    (2048, None), (2049, jax.lax.Precision.HIGHEST)])
def test_precision_for_values_past_tf32(x, want):
    """TF32 holds integers up to 2^11; larger values ask for HIGHEST."""
    flow, dist = _pair_spec(x, 1).arrays()
    assert exactness_precision(flow, dist) == want


def test_incremental_exact_with_values_past_tf32():
    """An instance with flows past 2^11 (HIGHEST-precision products) keeps
    the incremental G, H and cost exact through a descent."""
    rng = np.random.default_rng(5)
    n = 12
    flow = np.triu(rng.integers(0, 2600, (n, n)), 1)
    dist = np.triu(rng.integers(0, 2, (n, n)), 1)
    spec = QAPSpec(flow=tuple(map(tuple, (flow + flow.T).tolist())),
                   dist=tuple(map(tuple, (dist + dist.T).tolist())))
    assert exactness_precision(*spec.arrays()) == jax.lax.Precision.HIGHEST
    _walk_incremental_descent(spec, steps=8)


def test_cli_checks_device_int32_cost():
    """The device's int32 rescore the QAP CLI compares with the host
    oracle equals it exactly, also past 2^24."""
    spec = QAPSpec.random(200, seed=3, max_val=100)
    flow, dist = spec.arrays()
    p = np.random.default_rng(0).permutation(200)
    want = qap_cost_naive(flow, dist, p)
    assert want > 2**24
    assert int(qap_cost_int32(flow, dist, jnp.asarray(p))) == want


@pytest.mark.gpu
def test_incremental_update_exact_on_gpu():
    """On the GPU an f32 product may run in TF32, which rounds operands above
    2^11.  The incremental H (entries ~1e4 here) must still update exactly
    even when TF32 is the default, so H u asks for HIGHEST precision
    (models/qap.py)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    spec = QAPSpec.random(512, seed=0)
    assert float(np.max(np.asarray(spec.arrays()[0]))) * 512 > 2**11
    with jax.default_matmul_precision("tensorfloat32"):
        _walk_incremental_descent(spec, steps=12)
