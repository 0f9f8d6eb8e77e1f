"""Diagram layout domain: oracle scoring, delta neighborhoods, routing.

The reference never wired its diagram geometry into the solver (empty
DiagramSpecification/DiagramSolution at reference main.rs:7-9); these tests
cover the device-native completion of that domain: dense scoring vs a host
oracle, delta == full-rescore property, end-to-end solve to zero overlaps,
and connector routing over the C++ visibility graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from constraint_solver_tpu.models.diagram_layout import (
    DiagramLayoutSpec,
    layout_score_naive,
    layout_to_boxes,
    make_diagram_layout_problem,
)


@pytest.fixture(scope="module")
def spec():
    return DiagramLayoutSpec.random(8, 10, 8, seed=3)


@pytest.fixture(scope="module")
def problem(spec):
    return make_diagram_layout_problem(spec)


def test_score_matches_oracle(spec, problem):
    for seed in range(4):
        pos = problem.init(jax.random.key(seed))
        got = np.asarray(problem.score(pos))
        want = layout_score_naive(spec, np.asarray(pos))
        assert got[0] == want[0] and abs(got[1] - want[1]) < 1e-4


def test_packed_layout_scores_zero_hard():
    # 4 unit boxes on distinct cells: no overlaps; chain soft = sum of
    # center Manhattan distances.
    spec = DiagramLayoutSpec.chain(4, grid=4, size=1)
    problem = make_diagram_layout_problem(spec)
    pos = jnp.asarray([[0, 0], [1, 0], [2, 0], [3, 0]], jnp.int32)
    s = np.asarray(problem.score(pos))
    assert s[0] == 0.0 and s[1] == 3.0


def test_stacked_layout_counts_pairs():
    spec = DiagramLayoutSpec.chain(3, grid=4, size=2)
    problem = make_diagram_layout_problem(spec)
    pos = jnp.zeros((3, 2), jnp.int32)  # all three stacked: C(3,2) overlaps
    s = np.asarray(problem.score(pos))
    assert s[0] == 3.0 and s[1] == 0.0


def test_neighborhood_delta_equals_full_rescore(spec, problem):
    key = jax.random.key(1)
    pos = problem.init(key)
    cur = problem.score(pos)
    nbr = problem.neighborhood(pos, cur, key)
    b_idx, x_idx, y_idx = (np.asarray(m) for m in nbr.moves)
    scores = np.asarray(nbr.scores)
    valid = np.asarray(nbr.valid)
    sizes, _ = spec.arrays()
    rng = np.random.default_rng(0)
    for i in rng.choice(np.nonzero(valid)[0], 64, replace=False):
        p2 = np.asarray(pos).copy()
        p2[b_idx[i]] = (x_idx[i], y_idx[i])
        assert np.allclose(scores[i], layout_score_naive(spec, p2), atol=1e-3)
    # Every invalid candidate is out-of-grid or the no-op cell.
    mp = spec.grid - sizes
    pos_np = np.asarray(pos)
    bad = ~valid
    is_noop = (x_idx == pos_np[b_idx, 0]) & (y_idx == pos_np[b_idx, 1])
    assert np.all(
        (x_idx[bad] > mp[b_idx[bad], 0])
        | (y_idx[bad] > mp[b_idx[bad], 1])
        | is_noop[bad]
    )
    # Every in-grid non-no-op placement is valid; no-ops never are.
    good = valid
    assert np.all(
        (x_idx[good] <= mp[b_idx[good], 0]) & (y_idx[good] <= mp[b_idx[good], 1])
    )
    assert not np.any(is_noop[good])


def test_move_fp_matches_full_fingerprint(problem):
    key = jax.random.key(2)
    pos = problem.init(key)
    cur = problem.score(pos)
    fp = problem.fingerprint(pos)
    nbr = problem.neighborhood(pos, cur, key)
    for i in [0, 17, 200, 511]:
        idx = jnp.asarray(i)
        pos2 = problem.apply_move(pos, nbr.moves, idx)
        assert np.array_equal(
            np.asarray(problem.fingerprint(pos2)),
            np.asarray(problem.move_fp(pos, fp, nbr.moves, idx)),
        )


def test_perturb_stays_in_grid(spec, problem):
    key = jax.random.key(3)
    pos = problem.init(key)
    sizes, _ = spec.arrays()
    for seed in range(8):
        out = np.asarray(
            problem.perturb(pos, jnp.asarray(seed % 2 == 0), jax.random.key(seed))
        )
        assert np.all(out >= 0)
        assert np.all(out + sizes <= spec.grid)


def test_solver_reaches_zero_overlaps():
    from constraint_solver_tpu.core.ils import Solver, SolverConfig

    spec = DiagramLayoutSpec.random(6, 6, 8, seed=1, max_size=2)
    problem = make_diagram_layout_problem(spec)
    config = SolverConfig(
        seed="42",
        local_search_max_iterations=100,
        best_solutions_capacity=8,
        all_solutions_capacity=64,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=30,
        max_allow_no_improvement_for=5,
    )
    solver = Solver(problem, config)
    solver.run()
    (hard, soft), pos = solver.get_best_solution()
    assert hard == 0.0
    assert np.asarray(problem.score(pos))[0] == 0.0
    # Layout converts to non-degenerate geometry boxes.
    boxes = layout_to_boxes(spec, pos)
    assert len(boxes) == 6
    for b in boxes:
        x1, y1, x2, y2 = b.rect
        assert x2 > x1 and y2 > y1


def test_routing_end_to_end():
    from constraint_solver_tpu.diagram.route import (
        box_ports,
        render_routed,
        route_connectors,
        route_crossings,
    )

    spec = DiagramLayoutSpec.chain(4, grid=6, size=2)
    problem = make_diagram_layout_problem(spec)
    pos = jnp.asarray([[0, 0], [3, 0], [0, 3], [3, 3]], jnp.int32)
    assert np.asarray(problem.score(pos))[0] == 0.0
    boxes = layout_to_boxes(spec, pos)
    routes = route_connectors(boxes, list(spec.edges))
    assert len(routes) == 3
    # On-graph routing: no fallbacks, ever.
    assert all(r is not None for r in routes)
    # Routes never cross any box interior (ports sit on the boundary).
    assert route_crossings(routes, boxes) == 0
    port_sets = [set(box_ports(b)) for b in boxes]

    def near_port(v, ports):
        return any(abs(v[0] - p[0]) + abs(v[1] - p[1]) < 1e-3 for p in ports)

    for r, (i, j) in zip(routes, spec.edges):
        assert len(r) >= 2
        # Port-to-port: endpoints are actual ports of the connected boxes.
        assert near_port(r[0], port_sets[i])
        assert near_port(r[-1], port_sets[j])
        # Routed paths are orthogonal polylines over graph vertices.
        for a, b in zip(r, r[1:]):
            assert a[0] == b[0] or a[1] == b[1]
    svg = render_routed(boxes, list(spec.edges), path=None)
    assert svg.startswith("<svg") and svg.count("<rect") == 5


def test_cli_smoke(capsys):
    from constraint_solver_tpu.cli import diagram as cli

    rc = cli.main(
        [
            "--platform", "cpu", "--boxes", "5", "--edges", "4",
            "--grid", "8", "--rounds", "20", "--quiet",
        ]
    )
    out = capsys.readouterr().out
    assert "result.score" in out
    assert rc >= 0
